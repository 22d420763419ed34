"""RDCNet, the recurrent dilated-convolution network, twin of
``hcunet_tpu/models/rdcnet.py`` (reference ``hcat/r_unet.py:207-227``, its
StackedDilation block ``r_unet.py:339-364``).

Structure: stride-2 input conv → ``timesteps`` iterations of
``y = RDCBlock(cat(x, y)) + y`` → 3×3×3 conv → transposed conv back to full
resolution.  A Python loop takes the place of the JAX package's
``nn.scan``.  StackedDilation runs five 5×5×5 convs at dilations 1..5
(paddings 2, 4, 6, 8, 10 keep the size), concatenates them and merges with a
1×1×1 conv.  The parameters live in the reference's torch modules and names
(``strided_conv``, ``RDCblock.conv``, ``RDCblock.grouped_conv.conv{d}``,
``RDCblock.grouped_conv.out_conv``, ``out_conv``, ``transposed_conv``), the
names ``hcunet_tpu/utils/port_torch.py`` reads and writes.  Channels-last
``[B, X, Y, Z, C]``; the stride-1 convs are
:func:`~hcunet_tpu_torch.ops.conv.conv_same` (K1 on CUDA), the stride-2
input conv and the transposed conv plain PyTorch.
"""

from __future__ import annotations

import torch
from torch import nn

from hcunet_tpu_torch.config import RDCNetConfig
from hcunet_tpu_torch.models.unet import conv_weight_channels_last, tconv_weight_channels_last
from hcunet_tpu_torch.ops.conv import conv_same, conv_transpose_torch

DILATIONS = (1, 2, 3, 4, 5)


def _same(x, conv: nn.Conv3d, dtype, **kw):
    return conv_same(
        x.to(dtype), conv_weight_channels_last(conv.weight).to(dtype), conv.bias, **kw
    )


class StackedDilation(nn.Module):
    """Parallel dilated 5³ convs, concatenated, merged by a 1×1×1 conv."""

    def __init__(self, features: int, kernel: int = 5):
        super().__init__()
        for d in DILATIONS:
            setattr(self, f"conv{d}", nn.Conv3d(
                features, features, kernel, padding=2 * d, dilation=d
            ))
        self.out_conv = nn.Conv3d(len(DILATIONS) * features, features, 1)

    def forward(self, x, dtype: torch.dtype):
        outs = [
            _same(x, getattr(self, f"conv{d}"), dtype, padding=2 * d, dilation=d)
            for d in DILATIONS
        ]
        return _same(torch.cat(outs, dim=-1), self.out_conv, dtype)


class RDCBlock(nn.Module):
    """1×1×1 squeeze, then StackedDilation (``r_unet.py:367-378``)."""

    def __init__(self, features: int):
        super().__init__()
        self.conv = nn.Conv3d(2 * features, features, 1)
        self.grouped_conv = StackedDilation(features)

    def forward(self, x, dtype: torch.dtype):
        return self.grouped_conv(_same(x, self.conv, dtype), dtype)


class RDCNet(nn.Module):
    """The full recurrent dilated model.  ``dtype`` is the compute dtype;
    the recurrence's state stays float32 as in the JAX model, and the output
    is float32."""

    def __init__(self, config: RDCNetConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        c = config.complexity
        self.strided_conv = nn.Conv3d(config.in_channels, c, 3, stride=2, padding=1)
        self.RDCblock = RDCBlock(c)
        self.out_conv = nn.Conv3d(c, c, 3, padding=1)
        self.transposed_conv = nn.ConvTranspose3d(c, config.out_channels, 4, stride=2, padding=1)

    def step(self, x, y):
        """One recurrence iteration: ``y = RDCBlock(cat(x, y)) + y``."""
        return self.RDCblock(torch.cat([x, y], dim=-1), self.dtype) + y

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        if image.ndim != 5:
            raise ValueError(f"expected [B, X, Y, Z, C], got {tuple(image.shape)}")
        dtype = self.dtype
        x = _same(image, self.strided_conv, dtype, stride=2, padding=1)
        y = torch.zeros_like(x)
        for _ in range(self.config.timesteps):
            y = self.step(x, y)
        y = _same(y, self.out_conv, dtype, padding=1)
        return conv_transpose_torch(
            y.to(dtype), tconv_weight_channels_last(self.transposed_conv.weight).to(dtype),
            self.transposed_conv.bias, stride=2, padding=1,
        ).float()
