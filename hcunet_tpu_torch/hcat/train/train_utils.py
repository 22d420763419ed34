"""``hcat.train.train_utils``: the target generators, as the
preprocessing driver imports them (``preprocess_manual_masks.py:10,16-19``):
``makeMask(erosion=True)``, ``makePWL()``, ``CalculateCenterOfMass()``,
``VectorToCenter()``, callable instances that read a color-coded instance
mask (a tif path or an array, ``[Z, Y, X, C]``) and return the training
targets.

Over the port's :mod:`hcunet_tpu_torch.train.targets` (the reference's
``@njit`` loops as array operations; the reference-exact 63-ray PWL stays
available as ``makePWL(ray_march=True)``).
"""

import numpy as np

from hcunet_tpu_torch.train import targets as _targets
from hcunet_tpu_torch.train.targets import colors_to_labels  # noqa: F401


def _load_colormask(imagepath) -> np.ndarray:
    if isinstance(imagepath, np.ndarray):
        img = imagepath
    else:
        from hcunet_tpu_torch.data.tiff import imread

        img = np.asarray(imread(imagepath))
    if img.ndim == 3:
        img = np.stack([img] * 3, axis=3)
    return img


def colormask_to_mask(colormask: np.ndarray) -> np.ndarray:
    """``train_utils.py:175-187``: color-coded instances to a binary mask."""
    return (colors_to_labels(np.asarray(colormask)) != 0).astype(np.uint8)


class makePWL:
    """``train_utils.py:9-93``: the U-Net paper's pixel-wise weight map
    ``w0*exp(-(d1+d2)^2 / 2 sigma^2)``; float ``[Z, Y, X]``."""

    def __init__(self, ray_march: bool = False):
        self.ray_march = ray_march

    def __call__(self, imagepath) -> np.ndarray:
        return _targets.make_pwl(_load_colormask(imagepath), ray_march=self.ray_march)


class makeMask:
    """``train_utils.py:96-172``: background removal and inter-cell
    boundary stripping (and an optional per-z binary erosion); the cleaned
    color volume ``[Z, Y, X, C]``."""

    def __init__(self, erosion: bool = False):
        self.erosion = erosion

    def __call__(self, imagepath) -> np.ndarray:
        return _targets.make_mask(_load_colormask(imagepath), erosion=self.erosion)


class CalculateCenterOfMass:
    """``train_utils.py:190-237``: unique colors to integer ids; returns
    ``(center_of_mass [Z, Y, X] with each cell's id at its rounded center of
    mass, id_volume [Z, Y, X] uint32)``."""

    def __call__(self, imagepath):
        return _targets.center_of_mass_target(_load_colormask(imagepath))


class VectorToCenter:
    """``train_utils.py:240-274``: each pixel's (z, y, x) offset to its own
    cell's center, normalized by the volume's shape; ``[Z, Y, X, 3]``.
    ``center`` and ``colormask`` are the two outputs of
    :class:`CalculateCenterOfMass`; ``mask`` is taken for the reference's
    signature and unused, as there."""

    def __call__(self, center, colormask, mask=None) -> np.ndarray:
        return _targets.vector_to_center(np.asarray(center), np.asarray(colormask))


__all__ = [
    "makePWL",
    "makeMask",
    "CalculateCenterOfMass",
    "VectorToCenter",
    "colormask_to_mask",
    "colors_to_labels",
]
