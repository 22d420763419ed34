"""Separable gaussian blur (twin of ``hcunet_tpu/ops/filters.py``'s
``gaussian_kernel1d`` and ``gaussian_blur``).

The blur of the pipeline's probability map (``hcat/main.py:130``,
``skimage.filters.gaussian``): edge (``nearest``) boundary, ``truncate=4``,
so the radius is ``int(4*sigma + 0.5)``.  Plain PyTorch.
"""

from __future__ import annotations

from typing import Sequence

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
