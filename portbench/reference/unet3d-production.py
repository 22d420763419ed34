"""Plain reference of ``unet3d-production``: the reference's shipped 3D
U-Net (wisamreid/HcUnet ``hcat/unet.py``'s ``Unet_Constructor`` with
``hcat/main.py:46-55``'s settings) and its whole-volume tiling
(``hcat/segment.py:21-136``), in plain PyTorch, float32 with TF32 off.

The network is written from the architecture: per level two valid convs
(grouped as the configuration states), each followed by inference batch
norm on its running statistics and a ReLU, a max pool between levels; up
the levels a transposed conv, a top-left crop of it and of the skip to
their common size, the two joined (upsampled first), two convs; a 1x1x1
output conv.  Nothing is folded: the batch norms run as written.  The
tiling is worked out again from the tile geometry: the volume mirrored
(the edge voxel repeated) by the halo on every face, its grid overhang
padded by repeating the last voxel, a regular grid of tiles of core plus
two halos, each tile's logits cropped to the core ``[halo, halo + core)``,
a sigmoid, tiles whose every input voxel is -1 set to 0, the cores
stitched and trimmed to the volume.  :func:`bucketed_map` adds the
serving wrapper's bucketing: each axis longer than the core rounded up to
whole cores, the volume mirrored (or, where the pad exceeds the axis,
edge-repeated) on its high side, the map cropped back.

Parameter names are the reference's torch module names, so the same
tensors load into the program's model and feed this one.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from portbench.reference.precision import Precision

EPS = 1e-5


def param_specs(cfg: dict):
    """``(name, shape, kind, scale)`` of every parameter and batch-norm
    statistic: He-normal kernels (fan-in per group; a transposed conv's
    per output voxel, its taps over the stride), small normal biases,
    batch norms near the identity."""
    g, feats = cfg["groups"], cfg["feature_sizes"]
    k1, k2, uk = cfg["kernel1"], cfg["kernel2"], cfg["upsample_kernel"]
    specs = []

    def conv(name, cin, cout, k, groups=g):
        fan = cin // groups * math.prod(k)
        specs.append((f"{name}.weight", (cout, cin // groups, *k), "normal", math.sqrt(2 / fan)))
        specs.append((f"{name}.bias", (cout,), "normal", 0.05))

    def bn(name, c):
        specs.append((f"{name}.weight", (c,), "uniform", 0.2))
        specs.append((f"{name}.bias", (c,), "normal", 0.05))
        specs.append((f"{name}.running_mean", (c,), "normal", 0.05))
        specs.append((f"{name}.running_var", (c,), "uniform", 0.25))

    cin = cfg["in_channels"]
    for i, f in enumerate(feats):
        p = f"down_steps.{i}"
        conv(f"{p}.conv1", cin, f, k1), bn(f"{p}.batch1", f)
        conv(f"{p}.conv2", f, f, k2), bn(f"{p}.batch2", f)
        cin = f
    for j, f in enumerate(reversed(feats[:-1])):
        p = f"up_steps.{j}"
        fan = 2 * f * math.prod(uk) / math.prod(cfg["upsample_stride"])
        specs.append((f"{p}.up_conv.weight", (2 * f, f, *uk), "normal", math.sqrt(2 / fan)))
        specs.append((f"{p}.up_conv.bias", (f,), "normal", 0.05))
        conv(f"{p}.conv1", 2 * f, f, k1), bn(f"{p}.batch1", f)
        conv(f"{p}.conv2", f, f, k2), bn(f"{p}.batch2", f)
    conv("out_conv", feats[0], cfg["out_channels"], (1, 1, 1), groups=1)
    return specs


def _conv_bn_relu(W, name, bn, x, groups, P: Precision):
    x = F.conv3d(P.rnd(x), P.rnd(W[f"{name}.weight"]), W[f"{name}.bias"], groups=groups)
    shape = (1, -1, 1, 1, 1)
    inv = torch.rsqrt(W[f"{bn}.running_var"] + EPS) * W[f"{bn}.weight"]
    x = (x - W[f"{bn}.running_mean"].view(shape)) * inv.view(shape) + W[f"{bn}.bias"].view(shape)
    return torch.relu(x)


def _block(W, p, x, groups, P):
    x = _conv_bn_relu(W, f"{p}.conv1", f"{p}.batch1", x, groups, P)
    return _conv_bn_relu(W, f"{p}.conv2", f"{p}.batch2", x, groups, P)


def _crop(x, size):
    return x[:, :, : size[0], : size[1], : size[2]]


def forward(W: Dict[str, torch.Tensor], cfg: dict, x: torch.Tensor, P: Precision) -> torch.Tensor:
    """Logits ``[B, Cout, X', Y', Z']`` of tiles ``x`` ``[B, C, X, Y, Z]``."""
    g, n = cfg["groups"], len(cfg["feature_sizes"])
    pool = tuple(cfg["max_pool_kernel"])
    skips = []
    for i in range(n):
        x = _block(W, f"down_steps.{i}", x, g, P)
        if i < n - 1:
            skips.append(x)
            x = F.max_pool3d(x, pool, pool)
    for j in range(n - 1):
        p = f"up_steps.{j}"
        x = F.conv_transpose3d(P.rnd(x), P.rnd(W[f"{p}.up_conv.weight"]), W[f"{p}.up_conv.bias"],
                               stride=tuple(cfg["upsample_stride"]))
        skip = skips.pop()
        common = [min(a, b) for a, b in zip(x.shape[2:], skip.shape[2:])]
        x = torch.cat([_crop(x, common), _crop(skip, common)], dim=1)
        x = _block(W, p, x, g, P)
    return F.conv3d(P.rnd(x), P.rnd(W["out_conv.weight"]), W["out_conv.bias"])


def _pad_index(n: int, lo: int, hi: int, mode: str, device) -> torch.Tensor:
    """Source index of each position of an axis of ``n`` padded by ``lo``
    and ``hi``: ``symmetric`` mirrors with the edge voxel repeated, ``edge``
    repeats the edge voxel."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    i = torch.where(i < 0, -i - 1, i)
    return torch.where(i >= n, 2 * n - 1 - i, i)


def _pad(vol: torch.Tensor, widths, mode: str) -> torch.Tensor:
    """``vol`` [X, Y, Z, C] padded on its three spatial axes."""
    for axis, (lo, hi) in enumerate(widths):
        if lo or hi:
            vol = vol.index_select(axis, _pad_index(vol.shape[axis], lo, hi, mode, vol.device))
    return vol


def tiled_map(W, cfg: dict, vol: torch.Tensor, P: Precision) -> torch.Tensor:
    """The probability map ``[X, Y, Z]`` of a normalized volume ``vol``
    ``[X, Y, Z, C]`` (float32) over the configuration's tile grid, one tile
    batch at a time."""
    tiles = cfg["tiles"]
    spatial = list(vol.shape[:3])
    core = [min(e, s) for e, s in zip(tiles["eval_size"], spatial)]
    halo = [min(p, s) for p, s in zip(tiles["pad"], spatial)]
    n_tiles = [-(-s // e) for s, e in zip(spatial, core)]
    vol = torch.nan_to_num(vol.float(), nan=0.0, posinf=1.0, neginf=0.0)
    vol = _pad(vol, [(h, h) for h in halo], "symmetric")
    vol = _pad(vol, [(0, n * e - s) for n, e, s in zip(n_tiles, core, spatial)], "edge")
    size = [e + 2 * h for e, h in zip(core, halo)]
    out = torch.zeros([n * e for n, e in zip(n_tiles, core)], device=vol.device)
    origins = [(a * core[0], b * core[1], c * core[2]) for a in range(n_tiles[0])
               for b in range(n_tiles[1]) for c in range(n_tiles[2])]
    with P.scope(), torch.no_grad():
        for start in range(0, len(origins), int(tiles["batch"])):
            group = origins[start: start + int(tiles["batch"])]
            x = torch.stack([vol[o[0]: o[0] + size[0], o[1]: o[1] + size[1],
                                 o[2]: o[2] + size[2]] for o in group])
            logits = forward(W, cfg, x.permute(0, 4, 1, 2, 3).contiguous(), P)
            prob = torch.sigmoid(logits[:, 0, halo[0]: halo[0] + core[0],
                                        halo[1]: halo[1] + core[1], halo[2]: halo[2] + core[2]])
            empty = (x == -1).flatten(1).all(1)
            prob = torch.where(empty[:, None, None, None], torch.zeros_like(prob), prob)
            for o, p in zip(group, prob):
                out[o[0]: o[0] + core[0], o[1]: o[1] + core[1], o[2]: o[2] + core[2]] = p
    return out[: spatial[0], : spatial[1], : spatial[2]]


def bucket_shape(cfg: dict, spatial: Sequence[int]) -> List[int]:
    """Each axis longer than the tile core rounded up to whole cores."""
    core = cfg["tiles"]["eval_size"]
    return [-(-s // e) * e if s > e else s for s, e in zip(spatial, core)]


def bucketed_map(W, cfg: dict, vol: torch.Tensor, P: Precision) -> torch.Tensor:
    """The serving wrapper's map of ``vol`` [X, Y, Z, C]: the volume padded
    on its high side to its bucket, mirrored where every axis's pad is at
    most its size and edge-repeated otherwise, mapped, cropped back."""
    spatial = list(vol.shape[:3])
    bucket = bucket_shape(cfg, spatial)
    mode = "symmetric" if all(b - s <= s for s, b in zip(spatial, bucket)) else "edge"
    padded = _pad(vol, [(0, b - s) for s, b in zip(spatial, bucket)], mode)
    return tiled_map(W, cfg, padded, P)[: spatial[0], : spatial[1], : spatial[2]]
