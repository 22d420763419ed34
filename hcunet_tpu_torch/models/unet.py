"""Generic valid-convolution U-Net, 2D or 3D (twin of
``hcunet_tpu/models/unet.py``).

The parameters live in the reference ``Unet_Constructor``'s torch modules and
names (``down_steps.{i}.conv1/batch1/conv2/batch2``,
``up_steps.{i}.up_conv/...``, ``out_conv``), so a reference state dict loads
as it is and ``hcunet_tpu.utils.port_torch`` reads this module's state dict.
The forward is the JAX ``UNet.apply``: channels-last ``[B, *spatial, C]``,
conv → BN → ReLU twice per block, max pool down, transpose conv up, top-left
crops at the skip joins and a 1×1 output conv, computed in ``dtype`` and
returned as float32 logits.  ``self.training`` is the JAX ``train=`` flag:
in training mode batch norm uses the batch's statistics and writes the new
running statistics into its buffers, as flax's ``mutable=["batch_stats"]``
returns them; in eval mode it uses the running statistics.
``reference_skip_bug=True`` joins a copy of the upsampled tensor instead of
the skip, as the reference does (``hcat/unet.py:313``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from hcunet_tpu_torch.config import UNetConfig
from hcunet_tpu_torch.core.shapes import unet_output_shape
from hcunet_tpu_torch.ops.conv import (
    batch_norm_inference,
    batch_norm_train,
    conv_transpose_torch,
    conv_valid,
    max_pool,
    update_running_stats,
)


def conv_weight_channels_last(w: torch.Tensor) -> torch.Tensor:
    """torch conv weight ``[Cout, Cin/g, *k]`` → ``[*k, Cin/g, Cout]``."""
    nd = w.ndim - 2
    return w.permute(tuple(range(2, 2 + nd)) + (1, 0))


def tconv_weight_channels_last(w: torch.Tensor) -> torch.Tensor:
    """torch transpose-conv weight ``[Cin, Cout, *k]`` → ``[*k, Cin, Cout]``."""
    nd = w.ndim - 2
    return w.permute(tuple(range(2, 2 + nd)) + (0, 1))


def crop_spatial(x: torch.Tensor, target_spatial: Sequence[int]) -> torch.Tensor:
    """Top-left crop of the spatial axes of a channels-last tensor."""
    slices = (slice(None),) + tuple(slice(0, int(t)) for t in target_spatial) + (
        slice(None),
    )
    return x[slices]


def _conv(nd: int, cin: int, cout: int, kernel, dilation: int = 1, groups: int = 1):
    cls = nn.Conv3d if nd == 3 else nn.Conv2d
    return cls(cin, cout, tuple(kernel), dilation=dilation, groups=groups)


def _bn(nd: int, c: int):
    return (nn.BatchNorm3d if nd == 3 else nn.BatchNorm2d)(c, eps=1e-5)


# flax nn.BatchNorm(momentum=0.9) in hcunet_tpu/models/unet.py: the running
# statistics keep 0.9 of their value and take 0.1 of the batch's
BN_MOMENTUM = 0.9


class ConvBNRelu(nn.Module):
    """One conv → batch norm → ReLU step.

    It holds no parameters: the conv and BN it applies belong to the
    enclosing block under the reference's names (``conv1``/``batch1``...).
    In training mode the batch norm is :func:`batch_norm_train` and the BN
    module's running statistics take the batch's (biased) statistics with
    momentum 0.9, as flax's ``nn.BatchNorm`` does."""

    def __init__(self, dilation: int = 1, groups: int = 1):
        super().__init__()
        self.dilation = dilation
        self.groups = groups

    def forward(self, x, conv: nn.Module, bn: nn.Module, dtype: torch.dtype):
        x = conv_valid(
            x.to(dtype),
            conv_weight_channels_last(conv.weight).to(dtype),
            conv.bias,
            dilation=self.dilation,
            groups=self.groups,
            accum_dtype=dtype,
        )
        if self.training:
            x, mean, var = batch_norm_train(x.to(dtype), bn.weight, bn.bias, bn.eps)
            update_running_stats(bn, mean, var, BN_MOMENTUM)
        else:
            x = batch_norm_inference(
                x.to(dtype), bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps
            )
        return torch.relu(x).to(dtype)


class Down(nn.Module):
    """Two ConvBNRelu steps (reference ``Down``, ``hcat/unet.py:236-266``)."""

    def __init__(self, nd, cin, features, kernel1, kernel2, dilation=1, groups=1):
        super().__init__()
        self.conv1 = _conv(nd, cin, features, kernel1, dilation, groups)
        self.batch1 = _bn(nd, features)
        self.conv2 = _conv(nd, features, features, kernel2, dilation, groups)
        self.batch2 = _bn(nd, features)
        self.step = ConvBNRelu(dilation, groups)

    def forward(self, x, dtype: torch.dtype = torch.float32):
        x = self.step(x, self.conv1, self.batch1, dtype)
        return self.step(x, self.conv2, self.batch2, dtype)


class Up(nn.Module):
    """Transpose-conv upsample, join skip, two ConvBNRelu steps
    (reference ``Up``, ``hcat/unet.py:269-315``)."""

    def __init__(
        self, nd, cin, features, kernel1, kernel2, up_kernel, up_stride,
        dilation=1, groups=1, reference_skip_bug=False,
    ):
        super().__init__()
        cls = nn.ConvTranspose3d if nd == 3 else nn.ConvTranspose2d
        self.up_conv = cls(cin, features, tuple(up_kernel), stride=tuple(up_stride))
        self.conv1 = _conv(nd, 2 * features, features, kernel1, dilation, groups)
        self.batch1 = _bn(nd, features)
        self.conv2 = _conv(nd, features, features, kernel2, dilation, groups)
        self.batch2 = _bn(nd, features)
        self.up_stride = tuple(up_stride)
        self.reference_skip_bug = reference_skip_bug
        self.step = ConvBNRelu(dilation, groups)

    def forward(self, x, skip, dtype: torch.dtype = torch.float32):
        x = conv_transpose_torch(
            x.to(dtype),
            tconv_weight_channels_last(self.up_conv.weight).to(dtype),
            self.up_conv.bias,
            stride=self.up_stride,
            accum_dtype=dtype,
        )
        common = [min(int(a), int(b)) for a, b in zip(x.shape[1:-1], skip.shape[1:-1])]
        x = crop_spatial(x, common)
        joined = x if self.reference_skip_bug else crop_spatial(skip, common).to(dtype)
        x = torch.cat([x, joined], dim=-1)
        x = self.step(x, self.conv1, self.batch1, dtype)
        return self.step(x, self.conv2, self.batch2, dtype)


class UNet(nn.Module):
    """The full encoder/decoder (reference ``Unet_Constructor``).

    ``dtype`` is the compute dtype of the forward; parameters stay float32."""

    def __init__(self, config: UNetConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        nd = config.image_dimensions
        feats = config.feature_sizes
        cins = (config.in_channels,) + tuple(feats[:-1])
        self.down_steps = nn.ModuleList(
            Down(nd, cin, f, config.kernel1, config.kernel2, config.dilation, config.groups)
            for cin, f in zip(cins, feats)
        )
        self.up_steps = nn.ModuleList(
            Up(
                nd, 2 * f, f, config.kernel1, config.kernel2,
                config.upsample_kernel, config.upsample_stride,
                config.dilation, config.groups, config.reference_skip_bug,
            )
            for f in reversed(feats[:-1])
        )
        self.out_conv = _conv(nd, feats[0], config.out_channels, (1,) * nd)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        nd = cfg.image_dimensions
        if x.ndim != nd + 2:
            raise ValueError(
                f"expected [B, *spatial({nd}), C] input, got shape {tuple(x.shape)}"
            )
        if x.shape[-1] != cfg.in_channels:
            raise ValueError(
                f"expected {cfg.in_channels} channels, got {x.shape[-1]}"
            )
        try:
            out_spatial = unet_output_shape(tuple(x.shape[1:-1]), **cfg.shape_kwargs())
        except ValueError as e:
            raise ValueError(
                f"input spatial {tuple(x.shape[1:-1])} too small for this "
                f"U-Net: {e}"
            ) from None
        if any(s <= 0 for s in out_spatial):
            raise ValueError(
                f"input spatial {tuple(x.shape[1:-1])} yields empty output "
                f"{out_spatial}; increase the input/tile size"
            )
        dtype = self.dtype
        skips = []
        for i, down in enumerate(self.down_steps):
            x = down(x, dtype)
            if i < len(self.down_steps) - 1:
                skips.append(x)
                x = max_pool(x, cfg.max_pool_kernel)
        for up in self.up_steps:
            x = up(x, skips.pop(), dtype)
        x = conv_valid(
            x.to(dtype),
            conv_weight_channels_last(self.out_conv.weight).to(dtype),
            self.out_conv.bias,
            accum_dtype=dtype,
        )
        return x.float()


@torch.no_grad()
def init_unet(
    config: UNetConfig,
    generator: Optional[torch.Generator] = None,
    dtype: torch.dtype = torch.float32,
) -> UNet:
    """Build a UNet on the CPU with He-normal conv weights drawn from
    ``generator`` (fan-in as in the JAX package's ``he_normal``), zero
    biases and identity batch norm."""
    model = UNet(config, dtype=dtype)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d, nn.ConvTranspose3d)):
            w = m.weight
            if isinstance(m, (nn.ConvTranspose2d, nn.ConvTranspose3d)):
                fan_in = w.shape[0] * math.prod(w.shape[2:])  # [Cin, Cout, *k]
            else:
                fan_in = w.shape[1] * math.prod(w.shape[2:])  # [Cout, Cin/g, *k]
            w.copy_(
                torch.randn(w.shape, generator=generator) * math.sqrt(2.0 / fan_in)
            )
            m.bias.zero_()
    return model.eval()


@torch.no_grad()
def init_like_flax(model: nn.Module, generator: torch.Generator, scale: float = 2.0) -> nn.Module:
    """Draw every conv and linear weight of ``model`` from ``generator`` with
    the distribution of flax's ``variance_scaling(scale, "fan_in",
    "truncated_normal")`` (``he_normal`` at 2, ``lecun_normal`` at 1: a
    normal truncated at two of its deviations, of variance ``scale /
    fan_in``), and zero every bias.  The fan-in is the JAX kernel's: Cin
    (per group) times the kernel's taps; for a transposed conv the torch
    weight ``[Cin, Cout, *k]`` gives Cin times the taps.  Batch norms keep
    their ones and zeros."""
    convs = (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d, nn.ConvTranspose3d, nn.Linear)
    for m in model.modules():
        if not isinstance(m, convs):
            continue
        w = m.weight
        if isinstance(m, nn.Linear):
            fan_in = w.shape[1]
        elif isinstance(m, (nn.ConvTranspose2d, nn.ConvTranspose3d)):
            fan_in = w.shape[0] * math.prod(w.shape[2:])
        else:
            fan_in = w.shape[1] * math.prod(w.shape[2:])
        # flax divides by the deviation of a unit normal truncated at +-2
        std = math.sqrt(scale / fan_in) / 0.87962566103423978
        draw = torch.empty(w.shape)  # drawn on the host, whatever the device
        nn.init.trunc_normal_(draw, 0.0, std, -2 * std, 2 * std, generator=generator)
        w.copy_(draw)
        if m.bias is not None:
            m.bias.zero_()
    return model
