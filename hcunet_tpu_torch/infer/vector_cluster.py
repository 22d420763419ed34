"""Vector-field clustering — pixels vote for their predicted centers.

Rebuild of ``hcat/segment.py:563-658`` (``pixel_vec_to_cell`` + the numba
``hist3d``): each foreground pixel adds its coordinates to its predicted
offset, votes land in a 3D histogram, smoothed peaks become cell centers,
and every pixel is assigned to the nearest center (zeroed under the mask
threshold).

Vectorized: the voting loop is ``np.add.at``; nearest-center assignment
uses a KD-tree over ≤ ``num_peaks`` centers instead of the reference's
per-center full-volume distance pass.  The port's own copy of
``hcunet_tpu/infer/vector_cluster.py``: host numpy and scipy, the same
labels.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage as ndi
from scipy.spatial import cKDTree

from hcunet_tpu_torch.ops.peaks import peak_local_max


def hist3d(centers: np.ndarray) -> np.ndarray:
    """Vote histogram.  ``centers``: [3, X, Y, Z] float coordinates
    (already index + offset).  Returns [X, Y, Z] normalized to max 1,
    initialized at 1 per bin like the reference (``segment.py:631-658``)."""
    shape = centers.shape[1:]
    hist = np.ones(shape, np.float64)
    idx = np.floor(centers.reshape(3, -1)).astype(np.int64)
    valid = (
        (idx[0] >= 0) & (idx[0] < shape[0])
        & (idx[1] >= 0) & (idx[1] < shape[1])
        & (idx[2] >= 0) & (idx[2] < shape[2])
    )
    np.add.at(hist, (idx[0][valid], idx[1][valid], idx[2][valid]), 1.0)
    return hist / hist.max()


def pixel_vec_to_cell(
    vector: np.ndarray,
    mask: np.ndarray,
    num_peaks: int = 100,
    mask_threshold: float = 0.2,
) -> np.ndarray:
    """``vector``: [X, Y, Z, 3] predicted offsets ordered (z, y, x) — the
    r-unet channel order (``segment.py:585-588``); ``mask``: [X, Y, Z]
    probability.  Returns [X, Y, Z] integer cell labels (0 = background).
    """
    X, Y, Z = vector.shape[:3]
    idx = np.indices((X, Y, Z)).astype(np.float64)  # [3, X, Y, Z] as (x,y,z)
    centers = idx.copy()
    # reference adds vector channels reversed: centers[x]+=vec[...,2] etc.
    centers[0] += vector[..., 2]
    centers[1] += vector[..., 1]
    centers[2] += vector[..., 0]

    hist = hist3d(centers)
    hist = ndi.maximum_filter(hist, size=2, mode="constant")
    hist = ndi.gaussian_filter(hist, sigma=5, mode="nearest")

    peaks = peak_local_max(hist, min_distance=1, num_peaks=num_peaks)
    label = np.zeros(hist.shape, np.int64)
    if len(peaks) == 0:
        return label

    pts = centers.reshape(3, -1).T
    tree = cKDTree(peaks.astype(np.float64))
    _, nearest = tree.query(pts, k=1)
    # reference labels cells by peak index starting at 0, so the first
    # (most intense) peak merges with background; start at 1 instead.
    label = (nearest + 1).reshape(X, Y, Z)
    label[np.asarray(mask, np.float64) < mask_threshold] = 0
    return label
