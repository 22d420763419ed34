"""``hcat.segment``: the inference surface, as the valscripts driver
imports it (``from hcat import mask as m, utils, segment``).

The four pipeline functions are the facade's (reference signatures,
channels-first layout); the vector-clustering pair speaks the reference's
array contracts.
"""

import numpy as np

from hcunet_tpu_torch.analysis.viz import _host
from hcunet_tpu_torch.compat import (  # noqa: F401
    generate_cell_objects,
    generate_unique_segmentation_mask_from_probability,
    predict_cell_candidates,
    predict_segmentation_mask,
)
from hcunet_tpu_torch.infer.vector_cluster import hist3d  # noqa: F401


def pixel_vec_to_cell(vector, mask, num_peaks: int = 100,
                      mask_threshold: float = 0.2) -> np.ndarray:
    """``segment.py:563-658``: cluster per-pixel center-offset votes into
    instance labels, on the host.  ``vector``: ``[1, 3, X, Y, Z]`` (the
    torch layout, channels (z, y, x)), ``[3, X, Y, Z]`` or channels-last
    ``[X, Y, Z, 3]``; ``mask``: the ``[X, Y, Z]`` probability (leading
    1-dims dropped).  Numpy or tensors on any device.  Returns ``[X, Y, Z]``
    int labels."""
    from hcunet_tpu_torch.infer.vector_cluster import pixel_vec_to_cell as _pvc

    vec = _host(vector)
    if vec.ndim == 5:  # [B, 3, X, Y, Z]
        vec = np.moveaxis(vec[0], 0, -1)
    elif vec.ndim == 4 and vec.shape[0] == 3 and vec.shape[-1] != 3:
        vec = np.moveaxis(vec, 0, -1)  # [3, X, Y, Z]
    m = _host(mask)
    while m.ndim > 3:
        m = m[0]
    return _pvc(vec, m, num_peaks=num_peaks, mask_threshold=mask_threshold)


__all__ = [
    "predict_segmentation_mask",
    "predict_cell_candidates",
    "generate_unique_segmentation_mask_from_probability",
    "generate_cell_objects",
    "pixel_vec_to_cell",
    "hist3d",
]
