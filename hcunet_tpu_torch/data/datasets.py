"""Datasets (twin of ``hcunet_tpu/data/datasets.py``): the Stack / Section /
RecursiveStack contracts of ``hcat/dataloader.py``.

Each dataset is an indexable host-side loader returning channels-last numpy
arrays, which ``UNetTrainer`` moves to the device.  Randomness is explicit: ``__getitem__``
takes an optional ``numpy.random.Generator`` (fresh per call otherwise), so
multi-worker pipelines stay reproducible.

File conventions preserved from the reference:
* ``Stack``: for every ``X.mask.tif`` load ``X.tif`` + ``X.pwl.tif``
  (``dataloader.py:40-63``); masks stored ``[X,Y,Z,C]`` take channel 0.
* ``Section``: PASCAL-VOC-ish ``*.xml`` + ``.tif`` pairs with classes
  OHC1/2/3, IHC → 1..4, optional collapse to {OHC:1, IHC:2}
  (``dataloader.py:146-178``).
* ``RecursiveStack``: Stack plus ``X.labels.com.tif`` and
  ``X.labels.vector.pkl`` (``dataloader.py:230-244``).
"""

from __future__ import annotations

import glob
import os
import pickle
import xml.etree.ElementTree
from typing import Callable, List, Optional, Sequence

import numpy as np

from hcunet_tpu_torch.data.tiff import imread


def _apply_joint(transforms, images: list, rng: np.random.Generator) -> list:
    for tr in transforms:
        images = tr(images, rng)
    return images


def _apply_image(transforms, image, rng: np.random.Generator):
    for tr in transforms:
        image = tr(image, rng)
    return image


class Stack:
    """tif/mask/pwl triplets for U-Net training."""

    def __init__(
        self,
        path: str,
        image_transforms: Sequence[Callable] = (),
        joint_transforms: Sequence[Callable] = (),
        out_transforms: Optional[Sequence[Callable]] = None,
        seed: int = 0,
    ):
        from hcunet_tpu_torch.data.transforms import to_batch

        self.image_transforms = list(image_transforms)
        self.joint_transforms = list(joint_transforms)
        self.out_transforms = (
            list(out_transforms) if out_transforms is not None else [to_batch()]
        )
        pattern = os.path.join(path, "*.mask.*")
        self.files = sorted(
            f for f in glob.glob(pattern) if f.endswith((".tif", ".tiff", ".npy"))
        )
        if not self.files:
            raise FileNotFoundError(f"no valid mask files found under {path}")
        self._rng = np.random.default_rng(seed)

        self.image: List[np.ndarray] = []
        self.mask: List[np.ndarray] = []
        self.pwl: List[np.ndarray] = []
        for mask_path in self.files:
            stem = os.path.splitext(os.path.splitext(mask_path)[0])[0]
            ext = os.path.splitext(mask_path)[1]
            self.image.append(imread(stem + ext))
            m = imread(mask_path)
            if m.ndim == 4:
                m = m[:, :, :, 0]
            self.mask.append(m)
            self.pwl.append(imread(stem + ".pwl" + ext))

    def __len__(self):
        return len(self.files)

    def __getitem__(self, item, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng(self._rng.integers(0, 2**31 - 1))
        image = self.image[item]
        mask = np.expand_dims(self.mask[item], -1)
        pwl = np.expand_dims(self.pwl[item], -1)
        image, mask, pwl = _apply_joint(
            self.joint_transforms, [image, mask, pwl], rng
        )
        image = _apply_image(self.image_transforms, image, rng)
        image, mask, pwl = _apply_joint(self.out_transforms, [image, mask, pwl], rng)
        return image, mask, pwl


LABEL_MAP = {"OHC1": 1, "OHC2": 2, "OHC3": 3, "IHC": 4}


class Section:
    """2D detection samples: image + {'boxes','labels'}."""

    def __init__(
        self,
        path: str,
        image_transforms: Sequence[Callable] = (),
        joint_transforms: Sequence[Callable] = (),
        out_transforms: Optional[Sequence[Callable]] = None,
        simple_class: bool = False,
        seed: int = 0,
    ):
        from hcunet_tpu_torch.data.transforms import to_batch

        self.image_transforms = list(image_transforms)
        self.joint_transforms = list(joint_transforms)
        self.out_transforms = (
            list(out_transforms) if out_transforms is not None else [to_batch()]
        )
        self.simple_class = simple_class
        self.files = sorted(glob.glob(os.path.join(path, "*.xml")))
        if not self.files:
            raise FileNotFoundError(f"no VOC xml files found under {path}")
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.files)

    @staticmethod
    def parse_xml(path: str):
        root = xml.etree.ElementTree.parse(path).getroot()
        boxes, labels = [], []
        for obj in root.iter("object"):
            for cls in obj.iter("name"):
                if cls.text not in LABEL_MAP:
                    raise ValueError(f"unidentified label {cls.text!r} in {path}")
                labels.append(LABEL_MAP[cls.text])
            for bb in obj.iter("bndbox"):
                boxes.append([int(bb[i].text) for i in range(4)])
        return boxes, labels

    def __getitem__(self, item, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng(self._rng.integers(0, 2**31 - 1))
        xml_path = self.files[item]
        image = imread(os.path.splitext(xml_path)[0] + ".tif")
        boxes, labels = self.parse_xml(xml_path)
        labels = np.asarray(labels, np.int32)
        if self.simple_class:
            labels = np.where(np.isin(labels, [2, 3]), 1, labels)
            labels = np.where(labels == 4, 2, labels)

        image = _apply_image(self.image_transforms, image, rng)
        kept = list(labels)
        for jt in self.joint_transforms:
            image, boxes, kept = jt(image, boxes, kept, rng)
        image = _apply_image(self.out_transforms, image, rng)
        return image, {
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "labels": np.asarray(kept, np.int32),
        }


class RecursiveStack(Stack):
    """Stack plus center-of-mass map + pixel→center vector field."""

    def __init__(self, path: str, **kwargs):
        super().__init__(path, **kwargs)
        self.com: List[np.ndarray] = []
        self.vec: List[np.ndarray] = []
        for mask_path in self.files:
            stem = os.path.splitext(os.path.splitext(mask_path)[0])[0]
            com = imread(stem + ".labels.com.tif")
            self.com.append(com[..., np.newaxis] if com.ndim == 3 else com)
            with open(stem + ".labels.vector.pkl", "rb") as f:
                self.vec.append(pickle.load(f))

    def __getitem__(self, item, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng(self._rng.integers(0, 2**31 - 1))
        image = self.image[item]
        mask = np.expand_dims(self.mask[item], -1)
        pwl = np.expand_dims(self.pwl[item], -1)
        com = self.com[item]
        vec = self.vec[item]
        group = _apply_joint(self.joint_transforms, [image, mask, pwl, com, vec], rng)
        image, mask, pwl, com, vec = group
        image = _apply_image(self.image_transforms, image, rng)
        group = _apply_joint(self.out_transforms, [image, mask, pwl, com, vec], rng)
        return tuple(group)
