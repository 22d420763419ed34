"""Feature Pyramid Network over C2..C5 → P2..P6 (twin of
``hcunet_tpu/models/fpn.py``), with torchvision's module names
(``inner_blocks.{i}.0``, ``layer_blocks.{i}.0``).  NCHW.

The top-down upsampling is the JAX package's ``jax.image.resize(...,
"nearest")``: source index ``floor((i + 0.5) * n_in / n_out)`` computed in
float32, which is torch's ``"nearest-exact"`` and not its ``"nearest"``
(they differ at 66 → 131, for one).  It is written out here as an index
gather so that the float32 arithmetic is the JAX package's own.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

_IN = ("c2", "c3", "c4", "c5")
_OUT = ("p2", "p3", "p4", "p5")


def _nearest_index(n_in: int, n_out: int, device) -> torch.Tensor:
    pos = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * n_in / n_out
    return torch.floor(pos).long()


def resize_nearest(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Nearest resize of the last two axes to ``size``, as
    ``jax.image.resize(method="nearest")``."""
    h, w = x.shape[-2:]
    if h != size[0]:
        x = x.index_select(-2, _nearest_index(h, size[0], x.device))
    if w != size[1]:
        x = x.index_select(-1, _nearest_index(w, size[1], x.device))
    return x


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 256):
        super().__init__()
        self.inner_blocks = nn.ModuleList(
            [nn.Sequential(nn.Conv2d(c, out_channels, 1)) for c in in_channels]
        )
        self.layer_blocks = nn.ModuleList(
            [nn.Sequential(nn.Conv2d(out_channels, out_channels, 3, padding=1))
             for _ in in_channels]
        )

    def forward(self, feats: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        laterals = [blk(feats[n]) for blk, n in zip(self.inner_blocks, _IN)]
        p = [None] * 4
        p[3] = laterals[3]
        for i in (2, 1, 0):
            p[i] = laterals[i] + resize_nearest(p[i + 1], laterals[i].shape[-2:])
        out = {lvl: blk(p[i]) for i, (lvl, blk) in enumerate(zip(_OUT, self.layer_blocks))}
        # p6: stride-2 max pool of p5 (torchvision LastLevelMaxPool)
        out["p6"] = F.max_pool2d(out["p5"], 1, 2, 0)
        return out
