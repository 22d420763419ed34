"""Reflection and edge padding for tiled valid-conv inference
(twin of ``hcunet_tpu/core/padding.py``).

The JAX code pads with ``jnp.pad(mode="symmetric")``: the edge voxel is
repeated in the mirror (``image[pad-1::-1]``, reference
``hcat/utils.py:52-55``).  ``torch.nn.functional.pad`` has no such mode — its
``reflect`` is numpy's ``reflect``, which skips the edge voxel — so both
"symmetric" and "edge" are built here from per-axis index vectors and
``index_select``, channels-last, on whatever device the tensor lives on.
"""

from __future__ import annotations

from typing import Sequence

import torch


def axis_index(size: int, lo: int, hi: int, mode: str, device) -> torch.Tensor:
    """Source index of every output position along one padded axis."""
    p = torch.arange(-lo, size + hi, device=device)
    if mode == "symmetric":
        p = torch.where(p < 0, -p - 1, p)
        p = torch.where(p >= size, 2 * size - 1 - p, p)
    elif mode == "edge":
        p = p.clamp(0, size - 1)
    else:
        raise ValueError(f"unsupported pad mode {mode!r}")
    return p


def pad_axes(x: torch.Tensor, widths: Sequence[tuple], mode: str) -> torch.Tensor:
    """Pad the spatial axes ``1..ndim-2`` of ``x`` by ``widths[i] = (lo, hi)``."""
    for i, (lo, hi) in enumerate(widths):
        if lo or hi:
            ax = i + 1
            idx = axis_index(x.shape[ax], int(lo), int(hi), mode, x.device)
            x = x.index_select(ax, idx)
    return x


def reflection_pad(x: torch.Tensor, pad_size: Sequence[int]) -> torch.Tensor:
    """Mirror-pad the spatial axes of a channels-last tensor.

    ``x`` is ``[B, *spatial, C]``; each face of spatial axis *i* gains
    ``pad_size[i]`` voxels, mirrored with the edge voxel included
    (numpy's ``mode="symmetric"``).  A pad larger than its axis raises, as a
    single symmetric pass cannot fill it.
    """
    spatial = x.shape[1:-1]
    if len(pad_size) != len(spatial):
        raise ValueError(
            f"pad_size {tuple(pad_size)} does not match spatial rank {len(spatial)}"
        )
    for p, s in zip(pad_size, spatial):
        if p < 0:
            raise ValueError(f"negative pad {p}")
        if p > s:
            raise ValueError(f"pad {p} larger than axis size {s}")
    return pad_axes(x, [(int(p), int(p)) for p in pad_size], "symmetric")


def pad_to_shape(
    x: torch.Tensor, target_spatial: Sequence[int], mode: str = "symmetric"
) -> torch.Tensor:
    """Right-pad the spatial axes of ``[B, *spatial, C]`` up to a target shape.

    Padding is appended on the high side only.  When an axis needs more
    symmetric padding than its size allows, that axis is edge-padded instead.
    """
    spatial = x.shape[1:-1]
    mode_widths = []
    edge_widths = []
    for s, t in zip(spatial, target_spatial):
        if t < s:
            raise ValueError(f"pad_to_shape cannot shrink {s} -> {t}")
        # only the axis whose pad exceeds its size falls back to edge
        # replication; other axes keep the requested mode
        if mode == "symmetric" and t - s > s:
            mode_widths.append((0, 0))
            edge_widths.append((0, t - s))
        else:
            mode_widths.append((0, t - s))
            edge_widths.append((0, 0))
    out = pad_axes(x, mode_widths, mode)
    return pad_axes(out, edge_widths, "edge")
