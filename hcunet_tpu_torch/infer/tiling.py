"""Batched tiled whole-volume inference (twin of ``hcunet_tpu/infer/tiling.py``).

Reflection-pad, cut a regular grid of uniform tiles (core ``eval_size`` plus
halo ``pad``), run the model on ``batch`` tiles at a time, sigmoid, apply the
empty-tile rule, optionally threshold, and write each tile's core into a
preallocated output — the reference's hot loop #1 (``hcat/segment.py:21-136``)
with tiles batched.  The JAX ``vmap``/``lax.map`` over tile batches becomes a
Python loop that gathers each batch by slicing.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from hcunet_tpu_torch.config import TileConfig, UNetConfig, resolve_device
from hcunet_tpu_torch.core.precision import exact_float32
from hcunet_tpu_torch.core.padding import pad_axes, reflection_pad
from hcunet_tpu_torch.core.shapes import calculate_indexes, unet_shrinkage
from hcunet_tpu_torch.ops.filters import gaussian_blur
from hcunet_tpu_torch.utils.profiling import span


def _check_geometry(
    tile_input: Sequence[int], eval_size: Sequence[int], pad: Sequence[int],
    unet_cfg: UNetConfig,
):
    """The model's shrink must fit inside the halo so the valid core aligns
    (the reference raises the same way at ``segment.py:127-132``)."""
    shrink = unet_shrinkage(tuple(tile_input), **unet_cfg.shape_kwargs())
    for s, p, e in zip(shrink, pad, eval_size):
        if e + p > (e + 2 * p) - s:  # i.e. shrink exceeds the halo
            raise ValueError(
                f"amount of padding is not sufficient: tile {tuple(tile_input)} "
                f"shrinks by {shrink}, need pad >= shrink per axis "
                f"(pad={tuple(pad)})"
            )


def _as_image(image, device) -> torch.Tensor:
    """``image`` (numpy or tensor) as a float32 tensor on the entry point's
    device."""
    dev = resolve_device(device)
    if isinstance(image, np.ndarray):
        image = torch.from_numpy(np.ascontiguousarray(image))
    return image.to(device=dev, dtype=torch.float32)


def _eval_tile_grid(
    padded: torch.Tensor,
    *,
    eval_size: Tuple[int, ...],
    pad: Tuple[int, ...],
    batch: int,
    n_tiles: Tuple[int, ...],
    apply_fn,
    use_probability_map: bool,
    threshold: float,
) -> torch.Tensor:
    """Evaluate the regular tile grid over an already-padded volume.

    ``padded``: ``[1, nx*ex + 2*px (+overhang), ..., C]``.  Returns the
    reassembled ``[1, nx*ex, ny*ey, nz*ez, Cout]`` core.
    """
    tile_in = tuple(e + 2 * p for e, p in zip(eval_size, pad))
    nx, ny, nz = n_tiles
    origins = [
        (ix * eval_size[0], iy * eval_size[1], iz * eval_size[2])
        for ix in range(nx) for iy in range(ny) for iz in range(nz)
    ]
    n = len(origins)
    # round n up to a multiple of batch with dummy origin-0 tiles, so every
    # forward sees the same batch shape
    origins += [(0, 0, 0)] * ((-n) % batch)

    out = None
    vol = padded[0]
    for start in range(0, len(origins), batch):
        obatch = origins[start : start + batch]
        tiles = torch.stack([
            vol[o[0] : o[0] + tile_in[0], o[1] : o[1] + tile_in[1],
                o[2] : o[2] + tile_in[2]]
            for o in obatch
        ])
        logits = apply_fn(tiles)  # [B, *out_spatial, Cout]
        # crop the trusted core: [pad : eval+pad] per axis (segment.py:103-106)
        core = logits[
            :,
            pad[0] : eval_size[0] + pad[0],
            pad[1] : eval_size[1] + pad[1],
            pad[2] : eval_size[2] + pad[2],
            :,
        ]
        prob = torch.sigmoid(core.float())
        # empty-tile parity: all-(-1) input tiles produce zeros
        empty = (tiles == -1).flatten(1).all(dim=1)
        prob = torch.where(empty[:, None, None, None, None], 0.0, prob)
        res = prob if use_probability_map else (prob > threshold).to(torch.uint8)
        if out is None:
            out = torch.empty(
                (1, nx * eval_size[0], ny * eval_size[1], nz * eval_size[2],
                 res.shape[-1]),
                dtype=res.dtype, device=padded.device,
            )
        for j, o in enumerate(obatch):
            if start + j < n:
                out[0, o[0] : o[0] + eval_size[0], o[1] : o[1] + eval_size[1],
                    o[2] : o[2] + eval_size[2]] = res[j]
    return out


@torch.no_grad()
def _tiled_forward(
    apply_fn,
    image: torch.Tensor,
    *,
    eval_size: Tuple[int, ...],
    pad: Tuple[int, ...],
    batch: int,
    n_tiles: Tuple[int, ...],
    use_probability_map: bool,
    threshold: float,
    postprocess: Optional[Tuple[float, float, float]] = None,
) -> torch.Tensor:
    """Scrub, pad, and evaluate the regular tile grid.

    ``image``: ``[1, X, Y, Z, C]`` (not modified).  Returns the trimmed
    ``[1, X, Y, Z, Cout]`` result.
    """
    with span("hcunet.tiling.tiles"):
        spatial = image.shape[1:-1]

        # nan/inf scrub (segment.py:66-67)
        image = torch.nan_to_num(image, nan=0.0, posinf=1.0, neginf=0.0)

        # halo by reflection (like the reference), then right-pad the ragged
        # grid overhang with edge replication — the overhang only feeds halo
        # regions that get cropped or trimmed anyway.
        padded = reflection_pad(image, pad)
        overhang = [n * e - s for n, e, s in zip(n_tiles, eval_size, spatial)]
        padded = pad_axes(padded, [(0, int(o)) for o in overhang], "edge")

        full = _eval_tile_grid(
            padded,
            eval_size=eval_size,
            pad=pad,
            batch=batch,
            n_tiles=n_tiles,
            apply_fn=apply_fn,
            use_probability_map=use_probability_map,
            threshold=threshold,
        )
        # trim grid-rounding overhang back to the true volume
        full = full[:, : spatial[0], : spatial[1], : spatial[2], :]

        if postprocess is not None:
            full = postprocess_epilogue(full, postprocess)
        return full


def postprocess_epilogue(prob: torch.Tensor, postprocess: Tuple[float, float, float]) -> torch.Tensor:
    """The pipeline's epilogue (``hcat/main.py:130-132``) on ``[1, X, Y, Z,
    C]`` probabilities, on their device: gaussian blur, probability floor,
    rescale."""
    sigma, floor, scale = postprocess
    prob = gaussian_blur(prob, sigma, axes=(1, 2, 3))
    return torch.where(prob < floor, 0.0, prob) * scale


@exact_float32()
def predict_segmentation_mask(
    apply_fn: Callable[[torch.Tensor], torch.Tensor],
    image,
    unet_cfg: UNetConfig,
    tile_cfg: Optional[TileConfig] = None,
    *,
    use_probability_map: bool = False,
    mask_cell_prob_threshold: float = 0.5,
    postprocess: Optional[Tuple[float, float, float]] = None,
    device=None,
) -> torch.Tensor:
    """Tiled semantic segmentation of a whole volume.

    ``apply_fn`` maps a batch of tiles ``[B, tx, ty, tz, C]`` to logits of
    the model's valid output shape.  ``image`` is ``[1, X, Y, Z, C]``
    channels-last, numpy or tensor; it is moved to ``device`` (CUDA unless
    given) under the ``hcunet.tiling.upload`` span, which a float32 tensor
    already there skips.  Returns ``[1, X, Y, Z, 1]`` on that device — float32
    probabilities when ``use_probability_map`` else uint8 {0,1}.
    ``postprocess=(sigma, floor, scale)`` adds the pipeline's
    blur/floor/rescale stage (only meaningful with ``use_probability_map``).
    """
    if tile_cfg is None:
        tile_cfg = TileConfig()
    if image.ndim != 5:
        raise ValueError(f"expected [1, X, Y, Z, C], got {tuple(image.shape)}")
    if not (isinstance(image, torch.Tensor) and image.dtype == torch.float32
            and image.device == resolve_device(device)):
        with span("hcunet.tiling.upload"):
            image = _as_image(image, device)

    spatial = tuple(image.shape[1:-1])
    eval_size = tuple(min(e, s) for e, s in zip(tile_cfg.eval_size, spatial))
    # single-pass symmetric reflection cannot exceed the axis size — clamp
    # the halo for small volumes (the geometry check still guarantees the
    # halo covers the network shrink, or raises).
    pad = tuple(min(int(p), int(s)) for p, s in zip(tile_cfg.pad, spatial))

    _check_geometry(
        tuple(e + 2 * p for e, p in zip(eval_size, pad)), eval_size, pad, unet_cfg
    )

    n_tiles = tuple(-(-s // e) for s, e in zip(spatial, eval_size))

    return _tiled_forward(
        apply_fn,
        image,
        eval_size=eval_size,
        pad=pad,
        batch=int(tile_cfg.batch),
        n_tiles=n_tiles,
        use_probability_map=bool(use_probability_map),
        threshold=float(mask_cell_prob_threshold),
        postprocess=None if postprocess is None else tuple(postprocess),
    )


def reference_tile_windows(
    spatial: Sequence[int], eval_size: Sequence[int], pad: Sequence[int]
):
    """The reference's exact (ragged) tile windows, for parity runs.

    Returns per-axis ``[start, stop]`` lists over the *padded* volume, as
    produced by ``hcat/segment.py:74-77`` via ``calculate_indexes``.
    """
    return [
        calculate_indexes(p, e, s, s + 2 * p)
        for p, e, s in zip(pad, eval_size, spatial)
    ]


@torch.no_grad()
@exact_float32()
def predict_segmentation_mask_reference_grid(
    apply_fn: Callable[[torch.Tensor], torch.Tensor],
    image,
    unet_cfg: UNetConfig,
    tile_cfg: Optional[TileConfig] = None,
    *,
    use_probability_map: bool = False,
    mask_cell_prob_threshold: float = 0.5,
    device=None,
) -> np.ndarray:
    """Parity variant walking the reference's exact ragged tile grid, one
    tile at a time.  Slow — use only to validate voxel placement against the
    reference.  Returns a numpy ``[1, X, Y, Z, 1]`` mask."""
    if tile_cfg is None:
        tile_cfg = TileConfig()
    image = _as_image(image, device)
    spatial = tuple(image.shape[1:-1])
    eval_size = [min(e, s) for e, s in zip(tile_cfg.eval_size, spatial)]
    pad = tuple(tile_cfg.pad)
    image = torch.nan_to_num(image, nan=0.0, posinf=1.0, neginf=0.0)
    padded = reflection_pad(image, pad)
    x_ind, y_ind, z_ind = reference_tile_windows(spatial, eval_size, pad)

    out_dtype = np.float32 if use_probability_map else np.uint8
    mask = np.zeros((1, *spatial, 1), out_dtype)

    for z0, z1 in z_ind:
        for x0, x1 in x_ind:
            for y0, y1 in y_ind:
                tile = padded[0, x0:x1, y0:y1, z0:z1, :]
                if bool(torch.all(tile == -1)):
                    continue
                out = torch.sigmoid(apply_fn(tile[None])[0].float())
                valid = out[
                    pad[0] : eval_size[0] + pad[0],
                    pad[1] : eval_size[1] + pad[1],
                    pad[2] : eval_size[2] + pad[2],
                    :,
                ].cpu().numpy()
                if not use_probability_map:
                    valid = (valid > mask_cell_prob_threshold).astype(np.uint8)
                xe = min(x0 + eval_size[0], spatial[0])
                ye = min(y0 + eval_size[1], spatial[1])
                ze = min(z0 + eval_size[2], spatial[2])
                mask[0, x0:xe, y0:ye, z0:ze, :] = valid[: xe - x0, : ye - y0, : ze - z0]
    return mask
