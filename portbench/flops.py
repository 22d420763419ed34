"""The benchmark's frozen arithmetic: the card's peaks, the operations and
bytes of one K1 launch, the K1 launches a request makes, and the model
FLOPs of a configuration.

Everything here is computed from shapes alone, never from the program:
the per-launch count is a copy of ``chip_smoke.py``'s (``in_range_taps``
and ``check_kernel``: only the (output, tap) pairs whose tap falls inside
the input do work, and each input, weight and output byte is counted
once), with a grouped conv counted at the work it needs (Cin / groups
inputs an output), and the layer lists follow each configuration's
published architecture.  The program's own launch counter is compared with the
length of these lists in the traced run, so a list gone stale shows.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence, Tuple

# NVIDIA H100 SXM data sheet, dense rates (the benchmark runs float32 with
# TF32 off, so float32 work is held to the FMA units' rate)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12
ELEMENT_BYTES = {"bfloat16": 2, "float32": 4}


def in_range_taps(n: int, p: int, k: int, d: int = 1) -> int:
    """Along one axis of a conv over an input of size ``n`` zero-padded by
    ``p`` on each side (kernel ``k``, dilation ``d``): the number of
    (output, tap) pairs whose tap falls inside the input."""
    return sum(1 for o in range(n + 2 * p - d * (k - 1)) for t in range(k)
               if p <= o + d * t < p + n)


@dataclass(frozen=True)
class Launch:
    """One K1 launch: a valid conv of the unpadded input ``x``
    ``[B, X, Y, Z, Cin]`` zero-padded by ``pad`` on each side, kernel
    ``kernel``, ``cout`` outputs, in ``groups`` groups.  Its operations and
    weight bytes are those the grouped conv needs, Cin / groups inputs to
    each output: the zero blocks of the block-diagonal dense weights that
    a program may hand K1 in its place are no work."""

    x: Tuple[int, int, int, int, int]
    kernel: Tuple[int, int, int]
    cout: int
    pad: Tuple[int, int, int] = (0, 0, 0)
    groups: int = 1

    def out_shape(self) -> Tuple[int, int, int]:
        return tuple(s + 2 * p - (k - 1) for s, p, k in zip(self.x[1:4], self.pad, self.kernel))

    def flops(self) -> float:
        pairs = self.x[0] * math.prod(
            in_range_taps(n, p, k) for n, p, k in zip(self.x[1:4], self.pad, self.kernel))
        return 2.0 * pairs * (self.x[4] // self.groups) * self.cout

    def bytes(self, dtype: str) -> float:
        es = ELEMENT_BYTES[dtype]
        out_vox = self.x[0] * math.prod(self.out_shape())
        w = math.prod(self.kernel) * (self.x[4] // self.groups) * self.cout
        return (math.prod(self.x) + w + out_vox * self.cout) * es + self.cout * 4

    def least_seconds(self, dtype: str) -> float:
        """The least time the card could take: the larger of operations
        over the dtype's peak and bytes over the memory bandwidth."""
        return max(self.flops() / PEAK_FLOPS[dtype], self.bytes(dtype) / PEAK_BYTES_PER_S)


# --- the production U-Net (valid convs) --------------------------------------


def _valid(sizes, k):
    return [s - (kk - 1) for s, kk in zip(sizes, k)]


def unet_k1_launches(cfg: dict, tile: Sequence[int], batch: int) -> List[Launch]:
    """K1's launches for one batch of ``batch`` tiles of ``tile`` [X, Y, Z]
    through the BN-folded serving forward: two valid convs a level down,
    two a level up (the transposed convs are cuDNN's), and the 1x1x1
    output conv (ungrouped; the others in the configuration's groups)."""
    feats, g = cfg["feature_sizes"], cfg["groups"]
    k1, k2 = cfg["kernel1"], cfg["kernel2"]
    pool, uk, us = cfg["max_pool_kernel"], cfg["upsample_kernel"], cfg["upsample_stride"]
    launches, skips = [], []
    sizes, cin = list(tile), cfg["in_channels"]
    for i, f in enumerate(feats):
        launches.append(Launch((batch, *sizes, cin), tuple(k1), f, groups=g))
        sizes = _valid(sizes, k1)
        launches.append(Launch((batch, *sizes, f), tuple(k2), f, groups=g))
        sizes = _valid(sizes, k2)
        cin = f
        if i < len(feats) - 1:
            skips.append(sizes)
            sizes = [s // p for s, p in zip(sizes, pool)]
    for f in reversed(feats[:-1]):
        up = [(s - 1) * st + k for s, st, k in zip(sizes, us, uk)]
        sizes = [min(a, b) for a, b in zip(up, skips.pop())]
        launches.append(Launch((batch, *sizes, 2 * f), tuple(k1), f, groups=g))
        sizes = _valid(sizes, k1)
        launches.append(Launch((batch, *sizes, f), tuple(k2), f, groups=g))
        sizes = _valid(sizes, k2)
    launches.append(Launch((batch, *sizes, feats[0]), (1, 1, 1), cfg["out_channels"]))
    return launches


def unet_macs_per_voxel(cfg: dict) -> float:
    """Multiply-adds of the U-Net per voxel of a request, over an unbounded
    volume: each conv's taps x (Cin / groups) x Cout at its level's share
    of the voxels (a pool of (2, 2, 1) quarters them), each transposed
    conv's taps x Cin x Cout per voxel of its input.  Halos that a tiling
    computes twice are not the model's work and are not counted."""
    feats, g = cfg["feature_sizes"], cfg["groups"]
    t1, t2 = math.prod(cfg["kernel1"]), math.prod(cfg["kernel2"])
    tu = math.prod(cfg["upsample_kernel"])
    shrink = math.prod(cfg["max_pool_kernel"])
    total, cin = 0.0, cfg["in_channels"]
    for level, f in enumerate(feats):
        share = shrink ** -level
        total += share * (t1 * cin / g * f + t2 * f / g * f)
        if level < len(feats) - 1:
            # the up level at this resolution: its transposed conv reads the
            # level below, then two convs over (upsampled + skip)
            total += shrink ** -(level + 1) * tu * 2 * f * f
            total += share * (t1 * 2 * f / g * f + t2 * f / g * f)
        cin = f
    total += feats[0] * cfg["out_channels"]
    return total


# --- the RecursiveUNet (same-padding convs) ----------------------------------


def runet_blocks(cfg: dict):
    """The RecursiveUNet's convs of one timestep in order, as ``(level,
    cin, cout, kind)``: ``level`` counts the (2, 2, 1) pools above the
    conv, ``kind`` is ``conv`` (3^3, padding 1), ``tconv`` (the up step's
    transposed conv, read at ``level``) or ``out`` (1x1x1)."""
    c0, c1, c2 = cfg["channels"]
    n_in = cfg["in_channels"] + cfg["out_channels"]
    blocks = [(0, n_in, c0, "conv"), (0, c0, c0, "conv")]
    for _gate in ("fh", "fz"):
        blocks += [(1, c0, c1, "conv"), (1, c1, c1, "conv"),
                   (2, c1, c2, "conv"), (2, c2, c2, "conv"),
                   (2, c2, c1, "tconv"),
                   (1, 2 * c1, c1, "conv"), (1, c1, c1, "conv")]
    blocks += [(1, c1, c0, "tconv"), (0, 2 * c0, c0, "conv"), (0, c0, c0, "conv"),
               (0, c0, cfg["out_channels"], "out")]
    return blocks


def _level_shape(shape, level, pool):
    return tuple(s // p ** level for s, p in zip(shape, pool))


def runet_serve_k1_launches(cfg: dict, shape: Sequence[int], batch: int) -> List[Launch]:
    """K1's launches of one ``compile_recurrent_apply`` forward (unsplit)
    over ``batch`` volumes of ``shape``: every same-padding conv with its
    padding, and each transposed conv as one conv of its four stacked
    parity kernels over its input zero-padded by (1, 1, 2) (kernel
    (6, 6, 5), torch padding 2: ``subpixel_pads``)."""
    k, uk, pool = tuple(cfg["kernel"]), cfg["upsample_kernel"], cfg["max_pool_kernel"]
    pad_same = tuple((kk - 1) // 2 for kk in k)
    up_pad = cfg["up_padding"]
    sub_k = (uk[0] // 2, uk[1] // 2, uk[2])
    sub_pad = (uk[0] // 2 - 1 - up_pad // 2, uk[1] // 2 - 1 - up_pad // 2, uk[2] - 1 - up_pad)
    step = []
    for level, cin, cout, kind in runet_blocks(cfg):
        sp = _level_shape(shape, level, pool)
        if kind == "conv":
            step.append(Launch((batch, *sp, cin), k, cout, pad_same))
        elif kind == "tconv":
            step.append(Launch((batch, *sp, cin), sub_k, 4 * cout, sub_pad))
        else:
            step.append(Launch((batch, *sp, cin), (1, 1, 1), cout))
    return step * cfg["timesteps"]


def runet_macs_per_voxel(cfg: dict) -> float:
    """Multiply-adds of the RecursiveUNet's forward per voxel of the
    request: every same-padding conv's taps x Cin x Cout at its level's
    share of the voxels, each transposed conv's taps x Cin x Cout per voxel
    of its input, over all timesteps."""
    taps, tu = math.prod(cfg["kernel"]), math.prod(cfg["upsample_kernel"])
    shrink = math.prod(cfg["max_pool_kernel"])
    total = 0.0
    for level, cin, cout, kind in runet_blocks(cfg):
        t = {"conv": taps, "tconv": tu, "out": 1}[kind]
        total += shrink ** -level * t * cin * cout
    return total * cfg["timesteps"]


def model_flops(cfg: dict, voxels: float) -> float:
    """The model's FLOPs (2 x multiply-adds) for one forward over
    ``voxels`` voxels of a request, from the configuration alone."""
    per = {"unet3d": unet_macs_per_voxel, "runet": runet_macs_per_voxel}[cfg["family"]](cfg)
    return 2.0 * per * voxels
