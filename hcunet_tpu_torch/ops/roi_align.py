"""RoIAlign — bilinear region-of-interest pooling (twin of
``hcunet_tpu/ops/roi_align.py``), with torchvision's ``aligned=False``
sampling.

For each RoI an ``output_size x output_size`` grid of bins, each sampled at
``sampling_ratio x sampling_ratio`` points, is gathered from a channels-last
feature map with bilinear weights and averaged.  Plain PyTorch: the four
corner reads are row gathers (``index_select``) from the ``[B*H*W, C]`` view
of the features.
"""

from __future__ import annotations

from typing import Optional

import torch


def _bilinear(
    flat: torch.Tensor, img: torch.Tensor, H: int, W: int,
    ys: torch.Tensor, xs: torch.Tensor,
) -> torch.Tensor:
    """Sample ``flat`` (``[B*H*W, C]``) of image ``img`` at float
    coordinates ``ys``/``xs`` (same shape ``S``); returns ``[*S, C]``."""
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    y1 = y0 + 1
    x1 = x0 + 1
    wy1 = ys - y0
    wx1 = xs - x0
    wy0 = 1.0 - wy1
    wx0 = 1.0 - wx1
    base = img * (H * W)

    def g(yi, xi):
        yi = yi.clamp(0, H - 1).long()
        xi = xi.clamp(0, W - 1).long()
        rows = (base + yi * W + xi).reshape(-1)
        return flat.index_select(0, rows).reshape(*yi.shape, flat.shape[-1])

    out = g(y0, x0) * (wy0 * wx0)[..., None]
    out = out + g(y0, x1) * (wy0 * wx1)[..., None]
    out = out + g(y1, x0) * (wy1 * wx0)[..., None]
    out = out + g(y1, x1) * (wy1 * wx1)[..., None]
    # torchvision zeroes samples fully outside the feature map
    inside = (ys >= -1) & (ys <= H) & (xs >= -1) & (xs <= W)
    return torch.where(inside[..., None], out, 0.0)


def roi_align(
    features: torch.Tensor,
    boxes: torch.Tensor,
    spatial_scale: float,
    output_size: int = 7,
    sampling_ratio: int = 2,
    batch_index: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``features``: ``[H, W, C]`` one image's feature map, or ``[B, H, W, C]``
    with ``batch_index`` ``[N]`` naming each box's image; ``boxes``: ``[N, 4]``
    ``(x1, y1, x2, y2)`` in input-image coordinates (x = width axis = feature
    dim 1).  Returns ``[N, out, out, C]``."""
    if features.ndim == 3:
        features = features[None]
    B, H, W, C = features.shape
    n = boxes.shape[0]
    if batch_index is None:
        batch_index = torch.zeros(n, dtype=torch.long, device=boxes.device)
    boxes = boxes.float() * spatial_scale
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    roi_w = torch.clamp(x2 - x1, min=1.0)
    roi_h = torch.clamp(y2 - y1, min=1.0)
    bin_w = roi_w / output_size
    bin_h = roi_h / output_size
    s = sampling_ratio
    dev = boxes.device
    ii = torch.arange(output_size, dtype=torch.float32, device=dev)
    kk = (torch.arange(s, dtype=torch.float32, device=dev) + 0.5) / s
    # [N, out, s] sample coordinates along each axis (no half-pixel shift)
    ys = y1[:, None, None] + (ii[None, :, None] + kk[None, None, :]) * bin_h[:, None, None]
    xs = x1[:, None, None] + (ii[None, :, None] + kk[None, None, :]) * bin_w[:, None, None]
    grid = (n, output_size, s, output_size, s)
    yy = ys[:, :, :, None, None].expand(grid)
    xx = xs[:, None, None, :, :].expand(grid)
    img = batch_index.long()[:, None, None, None, None].expand(grid)
    samples = _bilinear(features.reshape(B * H * W, C), img, H, W, yy, xx)
    return samples.mean(dim=(2, 4))
