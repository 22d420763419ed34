"""Separable filters and binary morphology (twin of
``hcunet_tpu/ops/filters.py``), plain PyTorch on the tensor's own device.

* :func:`gaussian_blur`: the blur of the pipeline's probability map
  (``hcat/main.py:130``, ``skimage.filters.gaussian``): edge (``nearest``)
  boundary, ``truncate=4``, so the radius is ``int(4*sigma + 0.5)``;
* :func:`maximum_filter`: ``scipy.ndimage.maximum_filter(mode='constant',
  cval=0)`` (``hcat/segment.py:601-605``);
* :func:`binary_dilation`, :func:`binary_erosion` and
  :func:`binary_dilation_n`: the full 3^nd structuring element
  (``skimage.morphology.binary_dilation``'s default, ``segment.py:456``).

A maximum over a box is the maximum of 1D maxima taken one axis after
another, and padding each axis in turn with the constant gives the same
window contents as padding all at once, so each window reduction is one
``F.max_pool1d`` per axis over a constant pad (a minimum is the maximum of
the negation): exact, whatever the order.  The two padding rules differ
for even windows and each function keeps its twin's: ``maximum_filter``
pads ``size // 2`` low (scipy's origin), the binary ops ``(size - 1) // 2``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from hcunet_tpu_torch.core.padding import axis_index


def gaussian_kernel1d(
    sigma: float, truncate: float = 4.0, device=None
) -> torch.Tensor:
    radius = int(truncate * sigma + 0.5)
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def gaussian_blur(
    x: torch.Tensor,
    sigma: float,
    axes: Sequence[int] | None = None,
    mode: str = "edge",
    truncate: float = 4.0,
) -> torch.Tensor:
    """Separable gaussian blur over the given axes (default: all), float32.

    ``mode='edge'`` matches skimage's default ``nearest`` boundary."""
    if sigma <= 0:
        return x
    k = gaussian_kernel1d(sigma, truncate, device=x.device)
    r = (k.shape[0] - 1) // 2
    axes = tuple(range(x.ndim)) if axes is None else tuple(axes)
    out = x.float()
    for ax in axes:
        if x.shape[ax] == 1:
            continue
        padded = out.index_select(ax, axis_index(x.shape[ax], r, r, mode, x.device))
        moved = padded.movedim(ax, -1)
        flat = moved.reshape(-1, 1, moved.shape[-1])
        conv = F.conv1d(flat, k.view(1, 1, -1))
        out = conv.reshape(moved.shape[:-1] + (-1,)).movedim(-1, ax)
    return out


def _reduce_axis(x: torch.Tensor, ax: int, size: int, lo: int, pad_value: float) -> torch.Tensor:
    """Maximum over a window of ``size`` along ``ax``, the axis padded with
    ``pad_value``: ``lo`` below and ``size - 1 - lo`` above."""
    moved = x.movedim(ax, -1)
    flat = F.pad(moved.reshape(-1, 1, moved.shape[-1]), (lo, size - 1 - lo), value=pad_value)
    out = F.max_pool1d(flat, size, stride=1)
    return out.reshape(moved.shape).movedim(-1, ax)


def _box_max(x: torch.Tensor, size: int, lo: int, pad_value: float, axes) -> torch.Tensor:
    for ax in axes:
        x = _reduce_axis(x, ax, size, lo, pad_value)
    return x


def _axes(x: torch.Tensor, axes: Optional[Sequence[int]]) -> tuple:
    return tuple(range(x.ndim)) if axes is None else tuple(a % x.ndim for a in axes)


def _window_reduce(x: torch.Tensor, size: int, reduce: str, pad_value: float, axes) -> torch.Tensor:
    """``reduce`` (``"max"`` or ``"min"``) over a window of ``size`` on each
    of ``axes``, padded with ``pad_value``, ``(size - 1) // 2`` low."""
    lo = (size - 1) // 2
    if reduce == "max":
        return _box_max(x, size, lo, pad_value, axes)
    return -_box_max(-x, size, lo, -pad_value, axes)


def maximum_filter(x: torch.Tensor, size: int, axes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """``scipy.ndimage.maximum_filter(mode='constant', cval=0)`` over
    ``axes`` (default: all).  Pads ``size // 2`` low and the rest high, as
    scipy centres an even window; the pad is 0, so a negative input is
    clipped to 0 at the border.  Returns the input's floating dtype
    (float32 for any other input)."""
    if not x.is_floating_point():
        x = x.float()
    return _box_max(x, size, size // 2, 0.0, _axes(x, axes))


def binary_dilation(x: torch.Tensor, axes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """One step of binary dilation with the full 3^nd structuring element
    over ``axes``; bool."""
    return _window_reduce(x.float(), 3, "max", 0.0, _axes(x, axes)) > 0


def binary_erosion(x: torch.Tensor, axes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """One step of binary erosion with the full 3^nd structuring element
    over ``axes``; the border is padded with 0, so it erodes.  bool."""
    return _window_reduce(x.float(), 3, "min", 0.0, _axes(x, axes)) > 0


def binary_dilation_n(
    x: torch.Tensor, iterations: int, axes: Optional[Sequence[int]] = None
) -> torch.Tensor:
    """``iterations`` steps of 3^nd dilation as one window of
    ``2 * iterations + 1`` (``segment.py:456-457`` loops 15 times); bool."""
    return _window_reduce(x.float(), 2 * iterations + 1, "max", 0.0, _axes(x, axes)) > 0
