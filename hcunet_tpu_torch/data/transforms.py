"""Layout and dtype transforms of the pipeline's input (the part of
``hcunet_tpu/data/transforms.py`` that ``analyze`` needs; numpy only).

The training transforms (augmentation, elastic deformation, ...) come with
the port's training slice.
"""

from __future__ import annotations

import numpy as np


def integer_unit_scale(dtype) -> float:
    """The [0,1] rescale divisor for an integer image dtype.

    Matches :class:`to_float` and the reference (``transforms.py:94-115``):
    ``2**bits`` (256 / 65536), NOT ``iinfo.max`` (255 / 65535) — every
    integer-ingestion path in the pipeline must use this same constant or
    probabilities near thresholds silently shift by ~0.39% (uint8)."""
    dt = np.dtype(dtype)
    if not np.issubdtype(dt, np.integer):
        raise TypeError(f"expected an integer dtype, got {dt}")
    return float(2 ** (8 * dt.itemsize))


class to_float:
    """uint8/uint16 → float in [0,1] (``transforms.py:94-115``)."""

    def __call__(self, images, rng=None):
        single = not isinstance(images, list)
        if single:
            images = [images]
        out = []
        for im in images:
            if im.dtype == np.uint16:
                im = im.astype(np.float64) / 2**16
            elif im.dtype == np.uint8:
                im = im.astype(np.float64) / 2**8
            elif np.issubdtype(im.dtype, np.floating):
                pass
            else:
                raise TypeError(f"expected uint8/uint16/float, got {im.dtype}")
            out.append(im)
        return out[0] if single else out


class reshape:
    """skimage layout [Z,Y,X,C] → [X,Y,Z,C] (2D: [Y,X,C] → [X,Y,C]);
    swapaxes(ndim-2, 0) exactly as ``transforms.py:139-156``."""

    def __call__(self, images, rng=None):
        single = not isinstance(images, list)
        if single:
            images = [images]
        out = [im.swapaxes(im.ndim - 2, 0) for im in images]
        return out[0] if single else out
