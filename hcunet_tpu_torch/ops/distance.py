"""Euclidean distance transforms (twin of ``hcunet_tpu/ops/distance.py``).

The reference computes per-z-slice ``cv2.distanceTransform(bin, DIST_L2, 5)``
(``hcat/segment.py:433-435``) — the distance from each foreground pixel to
the nearest background pixel.  :func:`edt` is the exact EDT as separable
passes, one per axis::

    d2 <- 0 on background, 1e12 on foreground
    d2[.., j, ..] <- min_k d2[.., k, ..] + (j - k)^2       (each axis)
    edt = sqrt(min(d2, 1e12))

For a CUDA tensor each pass is kernel K2 (``csrc/edt_pass.cu``): the lower
envelope of the parabolas ``d2[k] + (j - k)^2``, O(n) per row, with its
argmin taken exactly.  For a CPU tensor it is :func:`edt_plain`'s pass, the
min-plus form in plain PyTorch in blocks like the JAX ``_axis_pass``; any
other device raises.  Both round each square and each sum once, as XLA
does, and a minimum does not round, so where the inputs are integers
below 2^53 - n^2 and n <= 4096 (every ``(j - k)^2`` exact in float32) the
two agree bit for bit with each other and with the JAX ``edt``: this holds
at the instance tiles, where every intermediate is an integer below 2^24 or
float32(1e12).  :func:`edt_per_slice_host` is the scipy path.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence

import numpy as np
import torch

from hcunet_tpu_torch.csrc import CudaKernel

_INF = 1e12
# elements of the [rows, block, n] cost tensor the plain pass materializes
_PLAIN_BLOCK_ELEMS = 1 << 28
# K2 takes axes shorter than this (its boundary products stay exact in double)
_MAX_N = 1 << 26

_P, _L = ctypes.c_void_p, ctypes.c_longlong

EDT_PASS = CudaKernel("edt_pass.cu", "edt_pass", [_P, _P, _L, _L, _L, _P])


def _axes(ndim: int, axes: Optional[Sequence[int]]) -> tuple:
    return tuple(range(ndim)) if axes is None else tuple(a % ndim for a in axes)


def _dist2(binary: torch.Tensor) -> torch.Tensor:
    return torch.where(binary != 0, _INF, 0.0).to(torch.float32)


def _axis_pass_plain(dist2: torch.Tensor, axis: int) -> torch.Tensor:
    """``out[.., j, ..] = min_k dist2[.., k, ..] + (j - k)^2`` in blocks of
    j, sized so that one block's cost tensor stays under 2^28 elements."""
    n = dist2.shape[axis]
    moved = dist2.movedim(axis, -1)
    k = torch.arange(n, dtype=torch.float32, device=dist2.device)
    block = max(1, min(n, _PLAIN_BLOCK_ELEMS // max(1, moved.numel())))
    outs = []
    for j0 in range(0, n, block):
        j = torch.arange(j0, min(n, j0 + block), dtype=torch.float32, device=dist2.device)
        cost = moved[..., None, :] + (j[:, None] - k[None, :]) ** 2
        outs.append(cost.amin(dim=-1))
    return torch.cat(outs, dim=-1).movedim(-1, axis)


def edt_plain(binary: torch.Tensor, axes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`edt` (the min-plus passes of the JAX
    ``_axis_pass``), on any device."""
    dist2 = _dist2(binary)
    for ax in _axes(binary.ndim, axes):
        dist2 = _axis_pass_plain(dist2, ax)
    return torch.sqrt(torch.clamp(dist2, max=_INF))


def edt_axis_pass(dist2: torch.Tensor, axis: int) -> torch.Tensor:
    """One pass of kernel K2 over ``axis`` of a contiguous float32 CUDA
    tensor: ``out[.., j, ..] = min_k dist2[.., k, ..] + (j - k)^2`` through
    the lower envelope, one launch; returns a new tensor.

    Equal bit for bit to :func:`_axis_pass_plain` where ``dist2`` is
    integer-valued (below 2^53 - n^2) and n <= 4096; for non-negative
    values, within 2 ulps where n > 4096 (the squares round) and 1 ulp
    where they are not integers (0 measured in both,
    ``tests/test_torch_port_cuda.py``).  n must be below 2^26."""
    if dist2.device.type != "cuda":
        raise ValueError(f"edt_axis_pass: no kernel for device {dist2.device}")
    if dist2.dtype != torch.float32 or not dist2.is_contiguous():
        raise ValueError("edt_axis_pass takes a contiguous float32 tensor")
    axis %= dist2.ndim
    out = torch.empty_like(dist2)
    if dist2.numel() == 0:
        return out
    n = dist2.shape[axis]
    if n >= _MAX_N:
        raise ValueError(f"edt_axis_pass: axis length {n} is not below 2^26")
    inner = math.prod(dist2.shape[axis + 1:])
    rows = dist2.numel() // n
    fn = EDT_PASS.function()
    with torch.cuda.device(dist2.device):
        rc = fn(
            dist2.data_ptr(), out.data_ptr(), rows, n, inner,
            torch.cuda.current_stream(dist2.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"edt_pass kernel launch failed: CUDA error {rc}")
    EDT_PASS.launches += 1
    return out


def edt(binary: torch.Tensor, axes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Exact euclidean distance to the nearest zero element, over ``axes``
    (default: all).  ``binary``: any bool/number tensor, nonzero =
    foreground.  Matches ``scipy.ndimage.distance_transform_edt`` over the
    same axes; an axis with no background gives 1e6.

    A CUDA tensor launches K2 once per axis; a CPU tensor runs
    :func:`edt_plain`; any other device raises."""
    if binary.device.type == "cpu":
        return edt_plain(binary, axes)
    if binary.device.type != "cuda":
        raise ValueError(f"edt: no kernel for device {binary.device}")
    dist2 = _dist2(binary).contiguous()
    for ax in _axes(binary.ndim, axes):
        dist2 = edt_axis_pass(dist2, ax)
    return torch.sqrt(torch.clamp(dist2, max=_INF))


def edt_per_slice_host(binary: np.ndarray) -> np.ndarray:
    """Host path: exact EDT per z-slice of an [X, Y, Z] volume — the layout
    the instance segmenter consumes (``segment.py:433-435`` loops z)."""
    from scipy import ndimage as ndi

    out = np.zeros(binary.shape, np.float32)
    for z in range(binary.shape[-1]):
        out[..., z] = ndi.distance_transform_edt(binary[..., z] != 0)
    return out
