"""Local-maximum peak detection — ``skimage.feature.peak_local_max``
equivalent for the vector-field clustering path (``hcat/segment.py:601-605``);
the port's own copy of ``hcunet_tpu/ops/peaks.py`` (host numpy and scipy).

Semantics matched: a peak is a strictly-greater-than-neighborhood maximum
within a ``min_distance`` chebyshev radius; peaks are returned sorted by
intensity descending, truncated to ``num_peaks``.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage as ndi


def peak_local_max(
    image: np.ndarray,
    min_distance: int = 1,
    num_peaks: int = np.inf,
    threshold_abs: float = None,
    threshold_rel: float = None,
    exclude_border: bool = True,
) -> np.ndarray:
    """Coordinates [N, ndim] of local maxima, intensity-sorted descending."""
    image = np.asarray(image, np.float64)
    size = 2 * min_distance + 1
    maxed = ndi.maximum_filter(image, size=size, mode="constant")
    mask = image == maxed
    thr = threshold_abs if threshold_abs is not None else image.min()
    if threshold_rel is not None:
        thr = max(thr, threshold_rel * image.max())
    mask &= image > thr
    if exclude_border:
        for ax in range(image.ndim):
            slc = [slice(None)] * image.ndim
            slc[ax] = slice(0, min_distance)
            mask[tuple(slc)] = False
            slc[ax] = slice(image.shape[ax] - min_distance, None)
            mask[tuple(slc)] = False
    coords = np.column_stack(np.nonzero(mask))
    if coords.size == 0:
        return coords.reshape(0, image.ndim)
    vals = image[tuple(coords.T)]
    order = np.argsort(-vals, kind="stable")
    coords = coords[order]
    if np.isfinite(num_peaks) and len(coords) > num_peaks:
        coords = coords[: int(num_peaks)]
    return coords
