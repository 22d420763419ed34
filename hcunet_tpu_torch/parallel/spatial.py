"""Spatially sharded whole-volume inference over a device mesh (twin of
``hcunet_tpu/parallel/spatial.py``).

A volume's X axis is split into ``n`` slabs, one per ``spatial`` device.
Valid convolutions need a halo of neighbour voxels: each slab receives the
``hx``-wide edges of its neighbours as device-to-device copies (the JAX
package's ``lax.ppermute``), and devices 0 and n-1 reflect their own outer
face, which equals the global symmetric pad because the mirror reads only
voxels the edge device owns.  Y and Z get a local symmetric pad, the model
runs on the extended slab, its core is cropped and a sigmoid applied.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch

from hcunet_tpu_torch.core.padding import pad_axes
from hcunet_tpu_torch.parallel.mesh import SPATIAL_AXIS, Mesh, gather, replicate


def exchange_x_halo(slabs: List[torch.Tensor], hx: int) -> List[torch.Tensor]:
    """Each ``[1, x, Y, Z, C]`` slab extended along X by ``hx`` columns on
    both sides: its neighbours' edges, copied to its device, or its own face
    mirrored at the ends of the volume."""
    if hx == 0:  # slab[:, -0:] would be the whole slab
        return list(slabs)
    n = len(slabs)
    out = []
    for i, slab in enumerate(slabs):
        dev = slab.device
        left = (slabs[i - 1][:, -hx:].to(dev, non_blocking=True) if i > 0
                else slab[:, :hx].flip(1))
        right = (slabs[i + 1][:, :hx].to(dev, non_blocking=True) if i < n - 1
                 else slab[:, -hx:].flip(1))
        out.append(torch.cat([left, slab, right], dim=1))
    return out


def spatial_sharded_forward(
    apply_fn,
    mesh: Mesh,
    halo: Tuple[int, int, int],
    axis_name: str = SPATIAL_AXIS,
) -> Callable[[torch.Tensor], List[torch.Tensor]]:
    """Build a function evaluating ``apply_fn`` over an X-sharded volume.

    ``apply_fn`` maps ``[1, x+2hx, Y+2hy, Z+2hz, C] -> [1, >=x+hx, ...]``
    logits (a valid-conv net whose shrink fits inside the halo); a callable
    on every device, or one per device (:func:`~.mesh.replicate`).  The
    returned function takes the global volume ``[1, X, Y, Z, C]`` (X
    divisible by the axis size) and returns the ``[1, X/n, Y, Z, Cout]``
    float32 probability slabs, slab ``i`` on device ``i`` of ``axis_name``;
    :func:`~.mesh.gather` concatenates them."""
    devices = mesh.axis_devices(axis_name)
    n = len(devices)
    hx, hy, hz = (int(h) for h in halo)
    applies = replicate(apply_fn, devices)

    @torch.no_grad()
    def run(volume: torch.Tensor) -> List[torch.Tensor]:
        if volume.shape[1] % n:
            raise ValueError(f"X={volume.shape[1]} not divisible by spatial axis size {n}")
        slabs = [s.to(d, non_blocking=True) for s, d in zip(volume.chunk(n, dim=1), devices)]
        out = []
        for slab, ext in zip(slabs, exchange_x_halo(slabs, hx)):
            ext = pad_axes(ext, [(0, 0), (hy, hy), (hz, hz)], "symmetric")
            logits = applies[slab.device](ext)
            core = logits[:, hx: hx + slab.shape[1], hy: hy + slab.shape[2],
                          hz: hz + slab.shape[3], :]
            out.append(torch.sigmoid(core.float()))
        return out

    return run


__all__ = ["exchange_x_halo", "gather", "spatial_sharded_forward"]
