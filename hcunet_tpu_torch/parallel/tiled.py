"""Multi-device tiled inference: the batched tile grid composed with spatial
sharding over a device mesh (twin of ``hcunet_tpu/parallel/tiled.py``).

Each ``spatial`` device runs the port's tile engine
(:func:`hcunet_tpu_torch.infer.tiling._eval_tile_grid`) over its own X slab:

* the volume's X axis is split over the ``spatial`` devices;
* each slab receives a ``pad_x``-wide halo from its neighbours as
  device-to-device copies (devices 0 and n-1 mirror their own outer face,
  as the single-device engine's global symmetric pad does);
* Y/Z halos are local symmetric pads and the ragged grid overhang is
  edge-padded, as in :func:`~hcunet_tpu_torch.infer.tiling._tiled_forward`;
* each device evaluates its tile grid with the model's forward bound to it,
  so every conv of a shard runs on the shard's device (kernel K1 on a card).

Shards are dispatched one after another from one thread; on several cards
their work overlaps, since nothing waits for a card between shards.  The
slabs are gathered on the first ``spatial`` device, and the optional
blur/floor/rescale epilogue runs there on the gathered volume, so its
stencil sees exactly the single-device engine's array at the seams (the
JAX package leaves the blur's halo to GSPMD instead).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from hcunet_tpu_torch.config import TileConfig, UNetConfig, auto_tile_config
from hcunet_tpu_torch.core.padding import pad_axes
from hcunet_tpu_torch.core.shapes import unet_shrinkage
from hcunet_tpu_torch.infer.tiling import _eval_tile_grid, postprocess_epilogue
from hcunet_tpu_torch.parallel.mesh import SPATIAL_AXIS, Mesh, gather, replicate
from hcunet_tpu_torch.parallel.spatial import exchange_x_halo


def sharded_tiled_forward(
    apply_fn,
    mesh: Mesh,
    unet_cfg: UNetConfig,
    tile_cfg: TileConfig,
    *,
    axis_name: str = SPATIAL_AXIS,
    use_probability_map: bool = True,
    threshold: float = 0.5,
    postprocess: Optional[Tuple[float, float, float]] = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Build the multi-device tiled segmentation function.

    ``apply_fn`` maps a tile batch to logits: one callable for every
    device, or one per device (:func:`~.mesh.replicate`).  The returned
    function maps a global ``[1, X, Y, Z, C]`` volume to ``[1, X, Y, Z,
    Cout]`` float32 probabilities (uint8 when ``use_probability_map`` is
    off) on the first ``spatial`` device, equal to the single-device
    ``predict_segmentation_mask`` on the same tile geometry.
    ``postprocess=(sigma, floor, scale)`` adds the pipeline's epilogue on
    the gathered volume.

    Raises ``ValueError`` where the halo does not cover the network's
    shrink, where ``X`` does not divide into ``n * eval_x`` (callers
    bucket-pad; see ``infer/serving.py``) and where a slab is thinner than
    ``max(pad_x, eval_x)``."""
    devices = mesh.axis_devices(axis_name)
    n = len(devices)
    ex, ey, ez = (int(e) for e in tile_cfg.eval_size)
    px, py, pz = (int(p) for p in tile_cfg.pad)
    batch = int(tile_cfg.batch)

    tile_in = (ex + 2 * px, ey + 2 * py, ez + 2 * pz)
    shrink = unet_shrinkage(tile_in, **unet_cfg.shape_kwargs())
    # the trusted-core crop [pad : eval+pad] needs the model's shrink to fit
    # inside one halo (infer.tiling._check_geometry's contract)
    for s, p in zip(shrink, (px, py, pz)):
        if s > p:
            raise ValueError(
                f"halo {(px, py, pz)} does not cover the network shrink "
                f"{shrink} for tile {tile_in}"
            )
    applies = replicate(apply_fn, devices)

    @torch.no_grad()
    def run(volume: torch.Tensor) -> torch.Tensor:
        X, Y, Z = (int(s) for s in volume.shape[1:4])
        if X % (n * ex):
            raise ValueError(
                f"X={X} must divide into {n} shards of whole {ex}-wide tile "
                f"columns (bucket-pad the volume first)"
            )
        # a slab thinner than one halo would make the halo slices clamp to
        # narrower pieces and corrupt the output instead of failing
        if X // n < max(px, ex):
            raise ValueError(
                f"per-shard slab width {X // n} is thinner than the halo "
                f"pad_x={px} / tile eval_x={ex}; use fewer shards or a "
                f"larger volume"
            )
        slabs = [
            torch.nan_to_num(s.to(d, non_blocking=True), nan=0.0, posinf=1.0, neginf=0.0)
            for s, d in zip(volume.chunk(n, dim=1), devices)
        ]
        ny, nz = -(-Y // ey), -(-Z // ez)
        outs = []
        for slab, ext in zip(slabs, exchange_x_halo(slabs, px)):
            ext = pad_axes(ext, [(0, 0), (py, py), (pz, pz)], "symmetric")
            ext = pad_axes(ext, [(0, 0), (0, ny * ey - Y), (0, nz * ez - Z)], "edge")
            out = _eval_tile_grid(
                ext,
                eval_size=(ex, ey, ez),
                pad=(px, py, pz),
                batch=batch,
                n_tiles=(slab.shape[1] // ex, ny, nz),
                apply_fn=applies[slab.device],
                use_probability_map=use_probability_map,
                threshold=threshold,
            )
            outs.append(out[:, :, :Y, :Z, :])
        full = gather(outs, devices[0], dim=1)
        if postprocess is not None:
            full = postprocess_epilogue(full, postprocess)
        return full

    return run


def sharded_tile_config(
    unet_cfg: UNetConfig,
    tile_cfg: Optional[TileConfig] = None,
    *,
    n_shards: int,
    volume_shape: Optional[Tuple[int, int, int]] = None,
) -> TileConfig:
    """A tile geometry whose X core divides a per-shard slab evenly: the
    memory auto-tuner's choice, its X eval size shrunk to a divisor of the
    slab when ``volume_shape`` is given."""
    if tile_cfg is None:
        z = volume_shape[2] if volume_shape else 15
        tile_cfg = auto_tile_config(unet_cfg, z_extent=z)
    if volume_shape is None:
        return tile_cfg
    X = volume_shape[0]
    if X % n_shards:
        raise ValueError(f"X={X} not divisible by {n_shards} shards")
    x_loc = X // n_shards
    ex = min(int(tile_cfg.eval_size[0]), x_loc)
    while x_loc % ex:
        ex -= 1
    return TileConfig(
        eval_size=(ex, *tile_cfg.eval_size[1:]),
        pad=tile_cfg.pad,
        batch=tile_cfg.batch,
    )
