"""ResNet backbones of the detector (twin of ``hcunet_tpu/models/resnet.py``).

:class:`ResNet` keeps torchvision's ``resnet50`` module names
(``conv1``/``bn1``/``layer1..4``, bottlenecks ``conv1..3``/``bn1..3``/
``downsample``), so a ``fasterrcnn_resnet50_fpn`` state dict's
``backbone.body.*`` loads as it is.  Layers run NCHW (cuDNN's layout); the
feature dict ``c2..c5`` is NCHW too.  ``self.training`` is the JAX
``train=`` flag.  The batch norms (:class:`BatchNorm`) keep torch's
``BatchNorm2d`` names and, in eval mode, its forward with the running
statistics; in training mode they follow flax's default ``nn.BatchNorm``
(the JAX trunks' own): the batch's statistics with the biased variance,
and the running statistics updated in the buffers with momentum 0.99.
Each bottleneck's last batch norm starts with a zero scale, as the JAX
block's (the zero-init last BN).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from hcunet_tpu_torch.ops.conv import batch_norm_train, update_running_stats

# flax nn.BatchNorm's defaults, which the JAX trunks keep
FLAX_BN_MOMENTUM = 0.99
FLAX_BN_EPS = 1e-5


class BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (its parameters and buffers, and its eval-mode
    forward) with flax's training rule: :func:`batch_norm_train` over the
    channel axis 1 and :func:`update_running_stats` at momentum 0.99."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=FLAX_BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        y, mean, var = batch_norm_train(x, self.weight, self.bias, self.eps, channel_axis=1)
        update_running_stats(self, mean, var, FLAX_BN_MOMENTUM)
        return y


class BottleneckBlock(nn.Module):
    """1x1 → 3x3 (stride) → 1x1 (4x width) with a projected residual where
    the shape changes."""

    def __init__(self, in_channels: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, features, 1, bias=False)
        self.bn1 = BatchNorm(features)
        self.conv2 = nn.Conv2d(features, features, 3, stride=stride, padding=1, bias=False)
        self.bn2 = BatchNorm(features)
        self.conv3 = nn.Conv2d(features, features * 4, 1, bias=False)
        self.bn3 = BatchNorm(features * 4)
        nn.init.zeros_(self.bn3.weight)  # the zero-init last BN, as in JAX
        self.downsample = None
        if in_channels != features * 4 or stride != 1:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_channels, features * 4, 1, stride=stride, bias=False),
                BatchNorm(features * 4),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class ResNet(nn.Module):
    """Bottleneck ResNet; ``stage_sizes`` (3, 4, 6, 3) = ResNet50, ``width``
    64 = the real one (smaller for tests)."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3), width: int = 64):
        super().__init__()
        self.conv1 = nn.Conv2d(3, width, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(width)
        in_ch = width
        self.out_channels = []
        for stage, n_blocks in enumerate(stage_sizes):
            w = width * 2**stage
            blocks = []
            for b in range(n_blocks):
                blocks.append(BottleneckBlock(in_ch, w, 2 if (b == 0 and stage > 0) else 1))
                in_ch = w * 4
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
            self.out_channels.append(in_ch)
        self.n_stages = len(stage_sizes)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.max_pool2d(y, 3, 2, 1)  # pads with -inf, as flax's max_pool
        feats = {}
        for stage in range(self.n_stages):
            y = getattr(self, f"layer{stage + 1}")(y)
            feats[f"c{stage + 2}"] = y
        return feats


def _same_pad(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """flax ``padding="SAME"``: output ``ceil(n / stride)``, the odd pad at
    the end of each axis."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):  # F.pad lists the last axis first
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class SmallBackbone(nn.Module):
    """A light conv backbone for tests and small detectors, with the same
    output contract as :class:`ResNet` (c2..c5 at strides 4/8/16/32)."""

    def __init__(self, width: int = 16):
        super().__init__()
        self.strides = (4, 2, 2, 2)
        in_ch = 3
        self.out_channels = []
        for i in range(4):
            c = width * 2**i
            setattr(self, f"conv{i}_0", nn.Conv2d(in_ch, c, 3, stride=self.strides[i]))
            setattr(self, f"bn{i}", BatchNorm(c))
            setattr(self, f"conv{i}_1", nn.Conv2d(c, c, 3))
            in_ch = c
            self.out_channels.append(c)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        feats = {}
        y = x
        for i in range(4):
            y = getattr(self, f"conv{i}_0")(_same_pad(y, 3, self.strides[i]))
            y = F.relu(getattr(self, f"bn{i}")(y))
            y = F.relu(getattr(self, f"conv{i}_1")(_same_pad(y, 3, 1)))
            feats[f"c{i + 2}"] = y
        return feats
