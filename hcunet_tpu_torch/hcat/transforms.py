"""``hcat.transforms``: the reference's augmentation classes, as its
drivers import them (``from hcat import ... transforms as t``, ``import
hcat.transforms as t``).

The same class names and constructor keywords, over the port's
:mod:`hcunet_tpu_torch.data.transforms`; instances plug into the
:mod:`~hcunet_tpu_torch.hcat.dataloader` datasets.  As in the JAX alias,
randomness comes from an explicit ``np.random.Generator`` that the dataset
passes to each call (in place of the reference's global-seed
``@joint_transform``, ``transforms.py:15-91``), so ``rng`` follows the
reference's positional arguments.
"""

import glob
import os

import numpy as np

from hcunet_tpu_torch.data import transforms as _t
from hcunet_tpu_torch.data.transforms import (  # noqa: F401
    clean_image,
    distance_transform,
    drop_channel,
    elastic_deform,
    normalize,
    nul_crop,
    random_affine,
    random_crop,
    random_gamma,
    random_intensity,
    random_resize,
    random_rotate,
    random_x_flip,
    random_y_flip,
    remove_channel,
    reshape,
    spekle,
    to_batch,
    to_float,
)


class to_tensor(to_batch):
    """``transforms.py:118-136``: ``[x, y, z, c]`` to a batch.  Here the
    batch is channels-last float32 numpy ``[1, x, y, z, c]``, the layout the
    port's models take."""


class add_junk_image(_t.add_junk_image):
    """``transforms.py:634-725``: paste a random crop of a junk tif and drop
    the boxes it covers.  Takes the reference's constructor, a directory
    ``path`` of ``*.tif`` files, on top of the port's array-based one."""

    def __init__(self, path, channel_index=(0, 2, 3),
                 junk_image_size=(100, 100), normalize=None):
        from hcunet_tpu_torch.data.tiff import imread
        from hcunet_tpu_torch.data.transforms import integer_unit_scale

        files = sorted(glob.glob(os.path.join(path, "*.tif")))
        if len(files) < 1:
            raise FileNotFoundError(f"No valid *.tif files found at {path}")
        images = []
        for f in files:
            img = np.asarray(imread(f))
            if np.issubdtype(img.dtype, np.integer):
                img = img.astype(np.float32) / integer_unit_scale(img.dtype)
            if img.ndim == 3 and img.shape[-1] > len(channel_index):
                img = img[..., list(channel_index)]
            if isinstance(normalize, dict):
                img = (img - np.asarray(normalize["mean"])) / np.asarray(normalize["std"])
            images.append(img.astype(np.float32))
        super().__init__(images, junk_image_size=junk_image_size)


__all__ = [
    "to_float",
    "reshape",
    "to_tensor",
    "to_batch",
    "clean_image",
    "spekle",
    "random_gamma",
    "normalize",
    "drop_channel",
    "random_intensity",
    "random_rotate",
    "random_crop",
    "elastic_deform",
    "random_affine",
    "nul_crop",
    "random_x_flip",
    "random_y_flip",
    "random_resize",
    "remove_channel",
    "add_junk_image",
    "distance_transform",
]
