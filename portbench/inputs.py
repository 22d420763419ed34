"""Inputs and weights made from a seed, on the device, in a few large calls.

The benchmark makes everything both sides see: the weights (one flat draw
per kind, cut into the parameters a configuration's reference lists) and
the volumes (cells as blurred points of light in four channels, plus
noise, normalized to [-1, 1] as ``analyze`` normalizes a stack).  The
program and the plain reference are handed the same tensors.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# sub-seeds stay below 2^63, which every generator takes
_SEED_MOD = 2**63 - 1


def sub_seed(seed: int, *path) -> int:
    """A seed for one named stream of a run (weights, volume k, ...), the
    same for the same ``seed`` and ``path``."""
    words = [int(seed) % 2**64] + [int.from_bytes(str(p).encode()[:8].ljust(8, b"\0"), "little")
                                   for p in path]
    return int(np.random.SeedSequence(words).generate_state(2, np.uint64)[0]) % _SEED_MOD


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


# --- weights ---------------------------------------------------------------


def make_weights(specs: Sequence[Tuple[str, Tuple[int, ...], str, float]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """The parameters ``specs`` lists, ``(name, shape, kind, scale)``, drawn
    on ``device`` from ``seed`` in float32 with one draw per kind:
    ``normal`` (a conv kernel or bias: a normal of deviation ``scale``),
    ``uniform`` (a positive batch-norm weight or variance: uniform on
    ``[1 - scale, 1 + scale]``)."""
    gen = generator(seed, device)
    out: Dict[str, torch.Tensor] = {}
    for kind in ("normal", "uniform"):
        group = [s for s in specs if s[2] == kind]
        n = sum(math.prod(s[1]) for s in group)
        if not n:
            continue
        if kind == "normal":
            flat = torch.randn(n, generator=gen, device=device)
        else:
            flat = torch.rand(n, generator=gen, device=device).mul_(2).sub_(1)
        at = 0
        for name, shape, _kind, scale in group:
            size = math.prod(shape)
            piece = flat[at: at + size].view(shape)
            out[name] = piece * scale if kind == "normal" else 1.0 + piece * scale
            at += size
    return {name: out[name] for name, *_ in specs}


# --- volumes ---------------------------------------------------------------


def _blur_axis(x: torch.Tensor, sigma: float, axis: int) -> torch.Tensor:
    """Gaussian blur of ``x`` [X, Y, Z] along one axis (zero padding)."""
    r = int(3 * sigma)
    t = torch.arange(-r, r + 1, device=x.device, dtype=torch.float32)
    k = torch.exp(-t * t / (2 * sigma * sigma))
    k = (k / k.sum()).view(1, 1, -1)
    moved = x.movedim(axis, -1)
    flat = moved.reshape(-1, 1, moved.shape[-1])
    y = F.conv1d(flat, k, padding=r).reshape(moved.shape)
    return y.movedim(-1, axis)


def make_volume(shape: Sequence[int], seed: int, device, cell_pitch: int = 24,
                channels: int = 4) -> torch.Tensor:
    """A normalized [X, Y, Z, C] float32 volume on ``device``: about one
    cell per ``cell_pitch``^2 of the plane, each a point of light blurred to
    a blob (sigma 5 in x and y, 2 in z), seen in every channel at its own
    gain, plus noise; clipped to [0, 1] and normalized ``(v - 0.5) / 0.5``."""
    X, Y, Z = (int(s) for s in shape)
    gen = generator(seed, device)
    n_cells = max(1, X * Y // cell_pitch**2)
    pts = torch.zeros((X, Y, Z), device=device)
    pos = torch.rand((n_cells, 3), generator=gen, device=device)
    idx = (pos * torch.tensor([X, Y, Z], device=device)).long()
    idx = torch.minimum(idx, torch.tensor([X - 1, Y - 1, Z - 1], device=device))
    pts[idx[:, 0], idx[:, 1], idx[:, 2]] = 1.0
    for axis, sigma in ((0, 5.0), (1, 5.0), (2, 2.0)):
        pts = _blur_axis(pts, sigma, axis)
    pts = pts / pts.amax().clamp_min(1e-12)
    gains = 0.8 + 0.2 * torch.rand((channels,), generator=gen, device=device)
    noise = torch.randn((X, Y, Z, channels), generator=gen, device=device) * 0.02
    vol = (pts[..., None] * gains + 0.05 + noise).clamp_(0.0, 1.0)
    return (vol - 0.5) / 0.5
