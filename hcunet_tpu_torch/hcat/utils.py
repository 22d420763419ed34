"""``hcat.utils``: the reference's utility surface, as its drivers import
it (``from hcat.utils import cells_to_csv``, ``from hcat import utils as
u``, ``from hcat import mask as m, utils, segment``).

The names whose signatures already match are the port's own; the rest are
thin adapters from the reference's channels-first layout.  Arrays come
back as numpy unless noted.
"""

from typing import Tuple

import numpy as np
import torch

# signature-identical re-exports ---------------------------------------------
from hcunet_tpu_torch.analysis.cochlea import get_cochlear_length  # noqa: F401
from hcunet_tpu_torch.analysis.export import (  # noqa: F401
    cells_to_csv,
    color_from_ind,
    mask_to_lines,
)
from hcunet_tpu_torch.analysis.viz import _host, construct_instance_mask  # noqa: F401
from hcunet_tpu_torch.core.padding import reflection_pad, reflection_pad_np
from hcunet_tpu_torch.core.shapes import calculate_indexes  # noqa: F401
from hcunet_tpu_torch.infer.candidates import merge_cell_candidates  # noqa: F401


def pad_image_with_reflections(image, pad_size: Tuple[int, ...] = (30, 30, 6)):
    """``utils.py:33-74``: mirror-pad every spatial face of a ``[B, C, X,
    Y, Z]`` volume, the edge voxel included (numpy's ``symmetric``), with
    the reference's even-pad requirement.  Takes a numpy array or a tensor
    and returns the same kind: a tensor is padded on its own device (where
    a pad may not exceed its axis), an array by :func:`reflection_pad_np`."""
    for pad in pad_size:
        if pad % 2 != 0:
            raise ValueError("Padding must be divisible by 2")
    if isinstance(image, torch.Tensor):
        return reflection_pad(image.movedim(1, -1), pad_size).movedim(-1, 1).contiguous()
    arr = np.moveaxis(np.asarray(image), 1, -1)
    return np.moveaxis(reflection_pad_np(arr, pad_size), -1, 1)


def reconstruct_mask(path: str) -> np.ndarray:
    """``utils.py:256-292``: the semantic mask reassembled from the chunk
    spills under ``path``, ``[1, 1, X, Y, Z]`` like the reference's."""
    from hcunet_tpu_torch.infer.chunks import reconstruct_mask as _rm

    return np.asarray(_rm(path))[None, None]


def reconstruct_segmented(path: str) -> np.ndarray:
    """``utils.py:294-333``: the instance mask reassembled from the chunk
    spills (ids renumbered across chunks), ``[1, 1, X, Y, Z]``."""
    from hcunet_tpu_torch.infer.chunks import reconstruct_segmented as _rs

    return np.asarray(_rs(path))[None, None]


def _image_chw_to_hwc(image) -> np.ndarray:
    arr = _host(image)
    if arr.ndim == 3 and arr.shape[0] in (1, 3, 4):
        arr = np.moveaxis(arr, 0, -1)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    return arr


def imshow(inp):
    """``utils.py:369-377``: denormalize ((x*0.5)+0.5) a ``[C, H, W]``
    image and plot it."""
    from hcunet_tpu_torch.analysis.viz import imshow_denormalized

    return imshow_denormalized(_image_chw_to_hwc(inp))


def show_box_pred(image, output, thr: float = 0.90):
    """``utils.py:380-418``: overlay detection boxes colored by class.
    ``image``: ``[C, H, W]`` (the torch layout) or ``[H, W(, C)]``;
    ``output``: a torchvision-style list of result dicts (``output[0]`` is
    drawn, as in the reference) or one candidates dict."""
    from hcunet_tpu_torch.analysis.viz import show_box_pred as _sbp

    cand = output[0] if isinstance(output, (list, tuple)) else output
    return _sbp(_image_chw_to_hwc(image), {k: _host(v) for k, v in cand.items()}, threshold=thr)


def show_box_pred_simple(image, boxes):
    """``utils.py:421-444``: the box overlay without scores or classes."""
    b = _host(boxes).astype(np.float32).reshape(-1, 4)
    return show_box_pred(
        image,
        {"boxes": b, "scores": np.ones(len(b), np.float32),
         "labels": np.ones(len(b), np.int32)},
        thr=0.0,
    )


__all__ = [
    "pad_image_with_reflections",
    "calculate_indexes",
    "get_cochlear_length",
    "reconstruct_mask",
    "reconstruct_segmented",
    "merge_cell_candidates",
    "imshow",
    "show_box_pred",
    "show_box_pred_simple",
    "construct_instance_mask",
    "mask_to_lines",
    "color_from_ind",
    "cells_to_csv",
]
