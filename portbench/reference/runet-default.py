"""Plain reference of ``runet-default``: the reference's RecursiveUnet
(wisamreid/HcUnet ``hcat/r_unet.py:38-336``) in eval mode, in plain
PyTorch, float32 with TF32 off.

One of ``timesteps`` steps, from the image and the previous 5-channel state
``s`` (zeros at first) and gate state ``h`` (ones at first, 32 channels at
half resolution): ``a = down1(cat(image, s))``; ``x = pool(a)``; each gate
``f(x) = up1(down3(pool(b)), b)`` with ``b = down2(x)``; ``h = h * z +
(-1 * z * tanh(f_h(x)))`` with ``z = sigmoid(f_z(x))`` (the reference's
update, kept as written); ``s = out(up2(h, a))``.  A ``down`` block is two
3^3 convs with padding 1, each followed by batch norm and a ReLU; an
``up`` block is a (6, 6, 5) transposed conv of stride (2, 2, 1) and
padding 2, the skip joined after it, and a ``down`` block.  Pools are
(2, 2, 1).  Batch norm uses its running statistics.

Parameter names are the reference's torch module names, so the same
tensors load into the program's model and feed this one.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from portbench.reference.precision import Precision

EPS = 1e-5


def _blocks(cfg: dict):
    c0, c1, c2 = cfg["channels"]
    n_in = cfg["in_channels"] + cfg["out_channels"]
    blocks = [("down1", n_in, c0, None)]
    for gate in ("fh", "fz"):
        blocks += [(f"down2_{gate}", c0, c1, None), (f"down3_{gate}", c1, c2, None),
                   (f"up1_{gate}", 2 * c1, c1, (c2, c1))]
    blocks.append(("up2", 2 * c0, c0, (c1, c0)))
    return blocks


def param_specs(cfg: dict):
    """``(name, shape, kind, scale)`` of every parameter and batch-norm
    statistic: He-normal kernels (a transposed conv's fan-in per output
    voxel, its taps over the stride), small normal biases, batch norms
    near the identity."""
    k, uk = cfg["kernel"], cfg["upsample_kernel"]
    specs = []

    def conv(name, cin, cout, kern, fan):
        specs.append((f"{name}.weight", (cout, cin, *kern), "normal", math.sqrt(2 / fan)))
        specs.append((f"{name}.bias", (cout,), "normal", 0.05))

    for name, cin, cout, up in _blocks(cfg):
        if up is not None:
            fan = up[0] * math.prod(uk) / math.prod(cfg["upsample_stride"])
            specs.append((f"{name}.up_conv.weight", (up[0], up[1], *uk), "normal",
                          math.sqrt(2 / fan)))
            specs.append((f"{name}.up_conv.bias", (up[1],), "normal", 0.05))
        for j, c in ((1, cin), (2, cout)):
            conv(f"{name}.conv{j}", c, cout, k, c * math.prod(k))
            specs += [(f"{name}.batch{j}.weight", (cout,), "uniform", 0.2),
                      (f"{name}.batch{j}.bias", (cout,), "normal", 0.05),
                      (f"{name}.batch{j}.running_mean", (cout,), "normal", 0.05),
                      (f"{name}.batch{j}.running_var", (cout,), "uniform", 0.25)]
    c0 = cfg["channels"][0]
    conv("out_conv", c0, cfg["out_channels"], (1, 1, 1), c0)
    return specs


class _Net:
    """The eval model over the weights ``W`` (channels-first tensors),
    rounding each conv's operands by ``P``."""

    def __init__(self, W: Dict[str, torch.Tensor], cfg: dict, P: Precision):
        self.W, self.cfg, self.P = W, cfg, P
        self.pad = tuple((kk - 1) // 2 for kk in cfg["kernel"])
        self.pool = tuple(cfg["max_pool_kernel"])

    def bn(self, x, name):
        W, shape = self.W, (1, -1, 1, 1, 1)
        mean, var = W[f"{name}.running_mean"], W[f"{name}.running_var"]
        inv = torch.rsqrt(var + EPS) * W[f"{name}.weight"]
        return (x - mean.view(shape)) * inv.view(shape) + W[f"{name}.bias"].view(shape)

    def down(self, x, name):
        for j in (1, 2):
            x = F.conv3d(self.P.rnd(x), self.P.rnd(self.W[f"{name}.conv{j}.weight"]),
                         self.W[f"{name}.conv{j}.bias"], padding=self.pad)
            x = torch.relu(self.bn(x, f"{name}.batch{j}"))
        return x

    def up(self, x, skip, name):
        x = F.conv_transpose3d(self.P.rnd(x), self.P.rnd(self.W[f"{name}.up_conv.weight"]),
                               self.W[f"{name}.up_conv.bias"],
                               stride=tuple(self.cfg["upsample_stride"]),
                               padding=self.cfg["up_padding"])
        return self.down(torch.cat([x, skip], dim=1), name)

    def gate(self, x, g):
        b = self.down(x, f"down2_{g}")
        return self.up(self.down(F.max_pool3d(b, self.pool, self.pool), f"down3_{g}"), b,
                       f"up1_{g}")

    def __call__(self, image: torch.Tensor) -> torch.Tensor:
        """The last state ``s_T`` ``[B, out, X, Y, Z]`` of ``image``
        ``[B, C, X, Y, Z]`` (x and y multiples of 4)."""
        cfg = self.cfg
        B, _, X, Y, Z = image.shape
        s = image.new_zeros((B, cfg["out_channels"], X, Y, Z))
        h = image.new_ones((B, cfg["channels"][1], X // 2, Y // 2, Z))
        for _ in range(cfg["timesteps"]):
            a = self.down(torch.cat([image, s], dim=1), "down1")
            x = F.max_pool3d(a, self.pool, self.pool)
            hh = torch.tanh(self.gate(x, "fh"))
            z = torch.sigmoid(self.gate(x, "fz"))
            h = h * z + (-1.0 * z * hh)
            x = self.up(h, a, "up2")
            s = F.conv3d(self.P.rnd(x), self.P.rnd(self.W["out_conv.weight"]),
                         self.W["out_conv.bias"])
        return s


def serve(W, cfg: dict, image: torch.Tensor, P: Precision) -> torch.Tensor:
    """The eval forward's ``s_T`` ``[B, X, Y, Z, out]`` of ``image``
    ``[B, X, Y, Z, C]`` (channels last, as the program's entry takes it)."""
    with P.scope(), torch.no_grad():
        out = _Net(W, cfg, P)(image.float().permute(0, 4, 1, 2, 3))
    return out.permute(0, 2, 3, 4, 1)
