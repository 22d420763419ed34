"""Visualization helpers (twin of ``hcunet_tpu/analysis/viz.py``), the
rebuilds of ``hcat/utils.py:369-460``.

The plotting functions draw onto the current matplotlib axes and return
them; nothing calls ``plt.show()``, so they compose in scripts and
notebooks.  matplotlib is imported inside the functions that plot, so the
module imports where matplotlib is absent.  Every function takes numpy
arrays or tensors on any device and brings them to the host.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def imshow_denormalized(image, mean: float = 0.5, std: float = 0.5):
    """Denormalize ((x*std)+mean) and display a [H, W, C<=3] image
    (``utils.py:369-377``)."""
    import matplotlib.pyplot as plt

    img = np.clip(_host(image) * std + mean, 0, 1)
    plt.imshow(img if img.ndim == 2 or img.shape[-1] > 1 else img[..., 0])
    return plt.gca()


_CLASS_COLORS = ["k", "r", "b", "y", "w"]


def show_box_pred(image2d, candidates: Dict, threshold: float = 0.9):
    """Overlay detection boxes colored by class on a 2D image
    (``utils.py:380-418``).  Boxes are (x1, y1, x2, y2) in array axes."""
    import matplotlib.pyplot as plt

    img = _host(image2d)
    if img.min() < 0:
        img = np.clip(img * 0.5 + 0.5, 0, 1)
    plt.imshow(img, origin="lower", cmap="Greys_r")
    boxes = _host(candidates["boxes"]).reshape(-1, 4)
    scores = _host(candidates["scores"]) if "scores" in candidates else np.ones(len(boxes))
    labels = _host(candidates["labels"]) if "labels" in candidates else np.ones(len(boxes), int)
    for box, score, lab in zip(boxes, scores, labels):
        if score < threshold:
            continue
        c = _CLASS_COLORS[int(lab) % len(_CLASS_COLORS)]
        x1, y1, x2, y2 = box
        # array axis 0 is vertical in imshow; boxes store (dim0, dim1)
        plt.plot([y1, y2], [x1, x1], c, lw=0.5)
        plt.plot([y1, y2], [x2, x2], c, lw=0.5)
        plt.plot([y1, y1], [x1, x2], c, lw=0.5)
        plt.plot([y2, y2], [x1, x2], c, lw=0.5)
    return plt.gca()


def construct_instance_mask(cells: Sequence, base_mask) -> np.ndarray:
    """Rebuild an instance volume of ``base_mask``'s shape from HairCell
    crops (``utils.py:447-460``): cell ``i`` paints ``i + 1`` into its box
    where no earlier cell did; bad cells are skipped."""
    out = np.zeros(tuple(base_mask.shape), np.int32)
    for i, cell in enumerate(cells):
        if getattr(cell, "is_bad", False):
            continue
        x1, y1, z1, x2, y2, z2 = cell.image_coords
        out[x1:x2, y1:y2, z1:z2][out[x1:x2, y1:y2, z1:z2] == 0] = i + 1
    return out


def labels_to_rgb(labels) -> np.ndarray:
    """Colorize an instance label image with deterministic per-id colors
    (:func:`hcunet_tpu_torch.analysis.export.color_from_ind`)."""
    from hcunet_tpu_torch.analysis.export import color_from_ind

    labels = _host(labels)
    ids = np.unique(labels)
    lut = np.zeros((int(ids.max()) + 1 if len(ids) else 1, 4))
    for i in ids:
        if i:
            lut[int(i)] = np.clip(color_from_ind(int(i)), 0, 1)
    return lut[labels]
