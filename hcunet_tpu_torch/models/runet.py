"""Recurrent U-Net (GRU-style), twin of ``hcunet_tpu/models/runet.py``
(reference ``hcat/r_unet.py:38-204``).

Each of ``timesteps`` steps concatenates the image with the previous
5-channel state and runs a 2-level *same-padding* U-Net with two gated
branches:

    x   = down1(cat(image, s_t))         # 9 -> 16 channels
    a   = x;  x = maxpool(x)
    h   = tanh(fh(x));  z = sigmoid(fz(x))
    h_t = h_t * z + (-1 * z * h)         # note: NOT a standard GRU update
    s_t = out_conv(up2(h_t, a))          # -> 5 channels [prob, center, z/y/x]

A Python loop over the timesteps takes the place of the JAX package's
``nn.scan``.  The parameters live in the reference's torch modules and
names (``down1``, ``down2_fh``/``down2_fz``, ``down3_fh``/``down3_fz``,
``up1_fh``/``up1_fz``, ``up2``, ``out_conv``; ``conv1/batch1/conv2/batch2``
and ``up_conv`` inside), the names ``hcunet_tpu/utils/port_torch.py``
reads.  Channels-last ``[B, X, Y, Z, C]``; the same-padding convs are
:func:`~hcunet_tpu_torch.ops.conv.conv_same` (K1 on CUDA).  ``self.training``
is the JAX ``train=`` flag: in eval mode batch norm uses its running
statistics; in training mode each timestep normalizes with its own batch's
statistics and updates the running statistics in its buffers (flax's rule,
momentum 0.9), one timestep after another, as the JAX ``nn.scan`` carries
``batch_stats`` through the steps: after T steps the buffers have taken T
updates.

Parity notes, as in the JAX model:
* the update ``h_t*z + (-1*z*h)`` is kept verbatim (``r_unet.py:155``);
* ``reference_skip_bug`` joins a copy of the upsampled tensor instead of
  the skip (``r_unet.py:332``);
* odd x/y sizes lose a pixel through pool and upsample; the state is
  zero-padded back to the image's size (the reference crashes there).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from hcunet_tpu_torch.config import RUNetConfig
from hcunet_tpu_torch.models.unet import (
    BN_MOMENTUM,
    conv_weight_channels_last,
    crop_spatial,
    tconv_weight_channels_last,
)
from hcunet_tpu_torch.ops.conv import (
    batch_norm_inference,
    batch_norm_train,
    conv_same,
    conv_transpose_torch,
    max_pool,
    update_running_stats,
)

# RUp hard-wires torch padding=2 for its transposed conv (r_unet.py:300)
UP_PADDING = 2


class SameConvBNRelu(nn.Module):
    """conv (same padding) → BN → ReLU, the reference ``Down`` half.  It
    holds no parameters: the conv and BN belong to the enclosing block under
    the reference's names.  In training mode the batch norm is
    :func:`batch_norm_train` and the running statistics take the batch's
    with momentum 0.9, as the JAX block's ``nn.BatchNorm(momentum=0.9)``."""

    def __init__(self, padding: int = 1):
        super().__init__()
        self.padding = padding

    def forward(self, x, conv: nn.Conv3d, bn: nn.BatchNorm3d, dtype: torch.dtype):
        x = conv_same(
            x.to(dtype), conv_weight_channels_last(conv.weight).to(dtype), conv.bias,
            padding=self.padding, accum_dtype=dtype,
        )
        if self.training:
            x, mean, var = batch_norm_train(x.to(dtype), bn.weight, bn.bias, bn.eps)
            update_running_stats(bn, mean, var, BN_MOMENTUM)
        else:
            x = batch_norm_inference(
                x, bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps
            )
        return torch.relu(x).to(dtype)


class RDown(nn.Module):
    """Two same-padding conv-BN-ReLU steps (``r_unet.py:250-285``)."""

    def __init__(self, cin: int, features: int, kernel: Tuple[int, ...]):
        super().__init__()
        self.conv1 = nn.Conv3d(cin, features, tuple(kernel), padding=1)
        self.batch1 = nn.BatchNorm3d(features, eps=1e-5)
        self.conv2 = nn.Conv3d(features, features, tuple(kernel), padding=1)
        self.batch2 = nn.BatchNorm3d(features, eps=1e-5)
        self.step = SameConvBNRelu(1)

    def forward(self, x, dtype: torch.dtype):
        x = self.step(x, self.conv1, self.batch1, dtype)
        return self.step(x, self.conv2, self.batch2, dtype)


class RUp(nn.Module):
    """Transposed-conv upsample (padding 2), join, two convs
    (``r_unet.py:288-336``)."""

    def __init__(self, cin, features, kernel, up_kernel, up_stride, reference_skip_bug=False):
        super().__init__()
        self.up_conv = nn.ConvTranspose3d(
            cin, features, tuple(up_kernel), stride=tuple(up_stride), padding=UP_PADDING
        )
        self.conv1 = nn.Conv3d(2 * features, features, tuple(kernel), padding=1)
        self.batch1 = nn.BatchNorm3d(features, eps=1e-5)
        self.conv2 = nn.Conv3d(features, features, tuple(kernel), padding=1)
        self.batch2 = nn.BatchNorm3d(features, eps=1e-5)
        self.up_stride = tuple(up_stride)
        self.reference_skip_bug = reference_skip_bug
        self.step = SameConvBNRelu(1)

    def forward(self, x, skip, dtype: torch.dtype):
        x = conv_transpose_torch(
            x.to(dtype), tconv_weight_channels_last(self.up_conv.weight).to(dtype),
            self.up_conv.bias, stride=self.up_stride, padding=UP_PADDING, accum_dtype=dtype,
        )
        common = [min(int(a), int(b)) for a, b in zip(x.shape[1:-1], skip.shape[1:-1])]
        x = crop_spatial(x, common)
        joined = x if self.reference_skip_bug else crop_spatial(skip, common).to(dtype)
        x = torch.cat([x, joined], dim=-1)
        x = self.step(x, self.conv1, self.batch1, dtype)
        return self.step(x, self.conv2, self.batch2, dtype)


class GateBranch(nn.Module):
    """The ``f`` mini-U-Net of the two gates (``r_unet.py:232-246``): down,
    stash, pool, down, up.  It holds no parameters: the blocks are the
    model's ``down2_*``, ``down3_*`` and ``up1_*``."""

    def __init__(self, pool: Tuple[int, ...]):
        super().__init__()
        self.pool = tuple(pool)

    def forward(self, x, down_a: RDown, down_b: RDown, up: RUp, dtype: torch.dtype):
        x = down_a(x, dtype)
        b = x
        x = max_pool(x, self.pool)
        x = down_b(x, dtype)
        return up(x, b, dtype)


def crop_like(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Top-left crop of ``a``'s spatial axes to ``b``'s (identity when
    equal): keeps the carried gate state aligned for odd sizes."""
    if a.shape == b.shape:
        return a
    return crop_spatial(a, b.shape[1:-1])


class RecursiveUNet(nn.Module):
    """The full recurrent model (``r_unet.py:38-160``).

    ``dtype`` is the compute dtype of the forward; parameters stay float32.
    ``forward(image)`` returns the last state ``s_T`` ``[B, X, Y, Z, 5]`` in
    ``dtype``, and with ``return_sequence=True`` also every state,
    ``[T, B, X, Y, Z, 5]``, as the JAX model's scan returns them."""

    def __init__(self, config: RUNetConfig, reference_skip_bug: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.reference_skip_bug = reference_skip_bug
        self.dtype = dtype
        c0, c1, c2 = config.channels
        k, uk, us = config.kernel, config.upsample_kernel, config.upsample_stride
        self.down1 = RDown(config.in_channels + config.out_channels, c0, k)
        for gate in ("fh", "fz"):
            setattr(self, f"down2_{gate}", RDown(c0, c1, k))
            setattr(self, f"down3_{gate}", RDown(c1, c2, k))
            setattr(self, f"up1_{gate}", RUp(c2, c1, k, uk, us, reference_skip_bug))
        self.up2 = RUp(c1, c0, k, uk, us, reference_skip_bug)
        self.out_conv = nn.Conv3d(c0, config.out_channels, 1)
        self.gate = GateBranch(config.max_pool_kernel)

    def step(self, image, s_t, h_t):
        """One recurrence step (``r_unet.py:139-160``): ``(s, h)`` after it."""
        cfg, dtype = self.config, self.dtype
        spatial = image.shape[1:-1]
        x = self.down1(torch.cat([image.to(dtype), s_t], dim=-1), dtype)
        a = x
        x = max_pool(x, cfg.max_pool_kernel)
        h = torch.tanh(self.gate(x, self.down2_fh, self.down3_fh, self.up1_fh, dtype))
        z = torch.sigmoid(self.gate(x, self.down2_fz, self.down3_fz, self.up1_fz, dtype))
        h_t = crop_like(h_t, h) * z + (-1.0 * z * h)  # r_unet.py:155, verbatim
        x = self.up2(h_t, a, dtype)
        x = conv_same(
            x.to(dtype), conv_weight_channels_last(self.out_conv.weight).to(dtype),
            self.out_conv.bias, padding=0, accum_dtype=dtype,
        )
        if tuple(x.shape[1:-1]) != tuple(spatial):
            # odd xy sizes lose a pixel through pool -> upsample: zero-pad
            # the state back (identity for even sizes)
            pads = []
            for s, c in zip(reversed(spatial), reversed(x.shape[1:-1])):
                pads += [0, int(s) - int(c)]
            x = nn.functional.pad(x, [0, 0] + pads)
        return x, h_t.to(dtype)

    def forward(self, image: torch.Tensor, return_sequence: bool = False):
        cfg = self.config
        if image.ndim != 5:
            raise ValueError(f"expected [B, X, Y, Z, C], got {tuple(image.shape)}")
        B = image.shape[0]
        spatial = image.shape[1:-1]
        # the gate state's spatial shape: same-padding convs keep sizes, the
        # pool halves x/y (floor), the up step doubles and crops to the skip
        pooled = [s // k for s, k in zip(spatial, cfg.max_pool_kernel)]
        gate_xy = [
            (q if q % 2 == 0 else q - 1) if k > 1 else q
            for q, k in zip(pooled, cfg.max_pool_kernel)
        ]
        h = torch.ones((B, *gate_xy, cfg.channels[1]), dtype=self.dtype, device=image.device)
        s = torch.zeros((B, *spatial, cfg.out_channels), dtype=self.dtype, device=image.device)
        seq = []
        for _ in range(cfg.timesteps):
            s, h = self.step(image, s, h)
            seq.append(s)
        if return_sequence:
            return s, torch.stack(seq)
        return s
