"""Instance segmentation: detection-seeded watershed over the semantic map
(twin of ``hcunet_tpu/infer/instance.py``; the reference's hot loop #3,
``hcat/segment.py:221-505``).

1. filter cell candidates by score and by semantic-mask occupancy at the box
   center; pick ``best_z`` = the z-plane with the highest mean candidate
   score; keep boxes within ``z_tolerance`` of it;
2. paint per-box seeds: inside each (shrunk-by-5px) box, mark the voxels
   where the semantic probability attains the box maximum, replicated over 6
   z-slices starting at ``best_z``;
3. per spatial tile: a height map (the normalized probability map, or for a
   uint8 mask the per-z-slice exact EDT), each z-slice replicated
   ``expand_z`` times, the mask dilated, a background seed where the height
   < 0.15, the compact seeded watershed with lines, z decimated back; then
   labels touching the tile's edges are zeroed (seam-free merging) and the
   rest pasted into the global volume in tile order.

``cfg.backend`` picks the tile's flood:

* ``"fused"`` (default): one call of the host flood per tile
  (:func:`hcunet_tpu_torch.ops.watershed.instance_tile`), z-expansion and
  dilation virtual; the binary path's EDT is scipy's on the host.  Tiles
  flood concurrently on ``cfg.tile_workers`` threads (the flood releases the
  GIL); write-backs stay in tile order, so labels are the same at any worker
  count.
* ``"materialized"``: the reference's procedure with the z-expanded float64
  volumes built in numpy, ``scipy.ndimage.binary_dilation`` and the host
  :func:`~hcunet_tpu_torch.ops.watershed.watershed`; labels equal
  ``"fused"``'s bit for bit.
* ``"device"``: the tile on the card, the binary path's EDT kernel K2
  (:func:`hcunet_tpu_torch.ops.distance.edt`) and the bounded minimax
  relaxation (:func:`~hcunet_tpu_torch.ops.watershed_device.watershed_device`),
  tiles one after another.  Approximate on plateau tie-breaks.

Boxes are ``(x1, y1, x2, y2)`` in array axes (dim0, dim1) of the
``[X, Y, Z]`` volume, as :mod:`hcunet_tpu_torch.infer.detect` produces.
"""

from __future__ import annotations

import itertools
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from hcunet_tpu_torch.config import WatershedConfig, resolve_device
from hcunet_tpu_torch.core.shapes import calculate_indexes
from hcunet_tpu_torch.ops.distance import edt, edt_per_slice_host
from hcunet_tpu_torch.ops.watershed import instance_tile, watershed
from hcunet_tpu_torch.ops.watershed_device import _shift, watershed_device

BACKENDS = ("fused", "materialized", "device")


def _resolve_host_ram(host_ram_bytes: Optional[int] = None) -> int:
    if host_ram_bytes is not None:
        return host_ram_bytes
    try:
        import psutil

        return psutil.virtual_memory().total
    except ImportError:
        return 16 * 2**30


def _cap_tile_workers(
    workers: int, pad, ev, Z: int, cfg: WatershedConfig, host_ram_bytes: int,
    concurrent_stages: int = 1,
) -> int:
    """Cap concurrent flood workers so ``workers x per-tile-peak`` fits in
    half of host RAM (the JAX package's rule; ~25 B/voxel per tile for the
    fused/device backends, ``expand_z`` x 21 B/voxel for the materialized
    one), divided across ``concurrent_stages``."""
    tile_vox = (ev[0] + 2 * pad[0]) * (ev[1] + 2 * pad[1]) * max(Z, 1)
    if cfg.backend == "materialized":
        per_tile = tile_vox * max(1, int(cfg.expand_z)) * 21
    else:
        per_tile = tile_vox * 25
    budget = host_ram_bytes // 2 // max(1, int(concurrent_stages))
    return max(1, min(int(workers), int(budget // max(per_tile, 1))))


def _instance_tile_geometry(spatial, host_ram_bytes: Optional[int] = None):
    """The reference's CPU-RAM-keyed watershed tiling
    (``segment.py:237-242``) with its small-image fallback."""
    host_ram_bytes = _resolve_host_ram(host_ram_bytes)
    if round(host_ram_bytes / 1e9) >= 16:
        pad, ev = [56, 56], [1212, 1212]
    else:
        pad, ev = [64, 64], [412, 412]
    for d in range(2):
        if spatial[d] < ev[d] + 2 * pad[d]:
            ev[d] = spatial[d]
            pad[d] = 1
    return pad, ev


@torch.no_grad()
def _device_instance_tile(
    distance: Optional[np.ndarray], binary: np.ndarray, seed_tile: np.ndarray,
    cfg: WatershedConfig, device, edt_fn: Callable = edt,
) -> np.ndarray:
    """One instance tile on ``device``: z-replication, iterated cross
    dilation, background seed and the bounded minimax watershed.

    ``distance=None`` (the binary path) computes the per-z-slice EDT of
    ``binary`` on the device with ``edt_fn`` (K2 by default)."""
    E = int(cfg.expand_z)
    binm = torch.from_numpy(np.ascontiguousarray(binary != 0)).to(device)
    if distance is None:
        # per-z-slice 2D EDT of the foreground, like the reference's
        # cv2.distanceTransform loop (``hcat/segment.py:433-435``)
        dist = edt_fn(binm, axes=(0, 1))
    else:
        dist = torch.from_numpy(np.ascontiguousarray(distance, np.float32)).to(device)
    seeds = torch.from_numpy(np.ascontiguousarray(seed_tile, np.int32)).to(device)

    dist_e = dist.repeat_interleave(E, dim=2)
    dist_e = torch.where(dist_e < cfg.distance_floor, 0.0, dist_e)
    mask_e = binm.repeat_interleave(E, dim=2)
    for _ in range(int(cfg.expand_mask)):
        grown = mask_e.clone()
        for ax in range(3):
            for d in (1, -1):
                grown |= _shift(mask_e, ax, d, False)
        mask_e = grown
    seed_e = seeds.repeat_interleave(E, dim=2)
    seed_e = torch.where(dist_e < cfg.seed_background_below, 1, seed_e)
    labels = watershed_device(
        -dist_e,
        seed_e,
        mask=mask_e,
        iters=int(cfg.device_iters),
        compactness=cfg.compactness,
        watershed_line=True,
    )
    return labels[:, :, ::E].contiguous().cpu().numpy()


def generate_unique_segmentation_mask(
    semantic: np.ndarray,
    candidates: Dict[str, np.ndarray],
    cfg: Optional[WatershedConfig] = None,
    host_ram_bytes: Optional[int] = None,
    progress=None,
    concurrent_stages: int = 1,
    device=None,
    edt_fn: Callable = edt,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns ``(unique_mask, seed)`` int32 volumes shaped like ``semantic``.

    ``semantic``: ``[X, Y, Z]`` float32 probability map (possibly blurred /
    rescaled by the pipeline) or uint8 binary mask.
    ``candidates``: dict of ``boxes [N,4] (x1,y1,x2,y2)``, ``scores [N]``,
    ``labels [N]``, ``z_level [N]`` (host numpy).  The host backends
    (``"fused"``, ``"materialized"``) run on the host and ignore ``device``;
    they flood up to ``cfg.tile_workers`` tiles at once, capped so that the
    tiles in flight fit in half of ``host_ram_bytes`` shared by
    ``concurrent_stages`` concurrent instance stages
    (:func:`_cap_tile_workers`).  ``backend="device"`` runs each tile on
    ``device`` (CUDA unless given), with ``edt_fn`` (K2's wrapper) for the
    binary path's EDT.
    """
    cfg = cfg or WatershedConfig()
    if cfg.backend not in BACKENDS:
        raise ValueError(f"unknown watershed backend {cfg.backend!r}")
    dev = resolve_device(device) if cfg.backend == "device" else None
    X, Y, Z = semantic.shape
    unique_mask = np.zeros((X, Y, Z), np.int32)
    seed = np.zeros((X, Y, Z), np.int32)

    boxes = np.asarray(candidates.get("boxes", np.zeros((0, 4))), np.float64)
    if boxes.size == 0 or len(candidates.get("scores", [])) == 0:
        return unique_mask, seed
    scores = np.asarray(candidates["scores"], np.float64)
    z_level = np.asarray(candidates["z_level"], np.float64)

    use_prob_map = semantic.dtype == np.float32
    if semantic.dtype not in (np.float32, np.uint8):
        raise ValueError(f"unknown semantic mask dtype {semantic.dtype}")

    # --- candidate filtering (segment.py:286-313) ---
    keep = scores > cfg.cell_prob_threshold
    b, s, z = boxes[keep], scores[keep], z_level[keep]
    cx = np.round(b[:, 0] + (b[:, 2] - b[:, 0]) / 2).astype(int)
    cy = np.round(b[:, 1] + (b[:, 3] - b[:, 1]) / 2).astype(int)
    cz = z.astype(int)
    inside = (cx >= 0) & (cx < X) & (cy >= 0) & (cy < Y) & (cz >= 0) & (cz < Z)
    occupied = np.zeros(len(b), bool)
    occupied[inside] = semantic[cx[inside], cy[inside], cz[inside]] > 0.5
    zs, ss = z[occupied], s[occupied]

    best_z = 0.0
    best_avg = 0.0
    for uz in np.unique(zs):
        avg = ss[zs == uz].mean()
        if avg > best_avg:
            best_z, best_avg = uz, avg
    best_z = int(best_z)

    # --- stabilize watershed by seeding in sorted-x order (segment.py:318-323)
    order = np.argsort(boxes[:, 0], kind="stable")
    boxes, scores, z_level = boxes[order], scores[order], z_level[order]

    # --- seed placement (segment.py:345-400) ---
    unique_cell_id = 2  # 1 is reserved for background (segment.py:274)
    seed_z_extent = 6
    for i, (x1, y1, x2, y2) in enumerate(boxes):
        if x1 > X or y1 > Y:
            continue
        if scores[i] < cfg.cell_prob_threshold:
            continue
        if not (best_z - cfg.z_tolerance <= z_level[i] <= best_z + cfg.z_tolerance):
            continue
        x2, y2 = min(x2, X - 1), min(y2, Y - 1)
        dx0, dx1 = (5 if x1 + 5 >= 0 else -x1), (-5 if x2 - 5 <= X else X - x2)
        dy0, dy1 = (5 if y1 + 5 >= 0 else -y1), (-5 if y2 - 5 <= Y else Y - y2)
        xa, xb = int(round(x1 + dx0)), int(round(x2 + dx1))
        ya, yb = int(round(y1 + dy0)), int(round(y2 + dy1))
        if xb <= xa or yb <= ya or best_z >= Z:
            unique_cell_id += 1
            continue
        box_prob = semantic[xa:xb, ya:yb, best_z]
        if box_prob.size == 0:
            unique_cell_id += 1
            continue
        peak = box_prob == box_prob.max()
        for dz in range(seed_z_extent):
            if best_z + dz >= Z:
                continue
            seed[xa:xb, ya:yb, best_z + dz][peak] = unique_cell_id
        unique_cell_id += 1

    # --- per-tile watershed (segment.py:403-499) ---
    host_ram_bytes = _resolve_host_ram(host_ram_bytes)
    pad, ev = _instance_tile_geometry((X, Y), host_ram_bytes)
    if ev[0] >= X:
        x_ind, pad_x = [[0, X]], 0
    else:
        x_ind, pad_x = calculate_indexes(pad[0], ev[0], X, X), pad[0]
    if ev[1] >= Y:
        y_ind, pad_y = [[0, Y]], 0
    else:
        y_ind, pad_y = calculate_indexes(pad[1], ev[1], Y, Y), pad[1]
    pad = [pad_x, pad_y]

    def flood_tile(x0, x1, y0, y1) -> np.ndarray:
        tile = semantic[x0:x1, y0:y1, :].astype(np.float64)
        if use_prob_map and tile.max() > 1:
            tile = tile + 1e-8
            tile = tile - tile.min()
            m = tile.max()
            if m > 0:
                tile = tile / m
            binary = tile > cfg.mask_prob_threshold
            distance = tile
        else:
            binary = tile > 0
            if cfg.backend == "device":
                distance = None  # the per-slice EDT runs on the device
            else:
                distance = edt_per_slice_host(binary.astype(np.uint8)).astype(np.float64)

        # seeds only from the trusted interior of the tile (segment.py:440-442)
        seed_tile = np.zeros_like(binary, dtype=np.int32)
        tw, th = x1 - x0, y1 - y0
        wx = min(pad[0] + ev[0], tw) - pad[0]
        wy = min(pad[1] + ev[1], th) - pad[1]
        if wx > 0 and wy > 0:
            seed_tile[pad[0] : pad[0] + wx, pad[1] : pad[1] + wy, :] = seed[
                x0 + pad[0] : x0 + pad[0] + wx,
                y0 + pad[1] : y0 + pad[1] + wy,
                :,
            ]

        if cfg.backend == "device":
            labels = _device_instance_tile(distance, binary, seed_tile, cfg, dev, edt_fn)
        elif cfg.backend == "fused":
            # one host call: virtual z-expansion + chamfer dilation + flood
            labels = instance_tile(
                distance, binary, seed_tile,
                expand_z=cfg.expand_z,
                expand_mask=cfg.expand_mask,
                distance_floor=cfg.distance_floor,
                seed_background_below=cfg.seed_background_below,
                connectivity=cfg.connectivity,
                compactness=cfg.compactness,
                watershed_line=True,
            )
        else:  # "materialized": fake isotropy by replicating z (segment.py:444-450)
            from scipy import ndimage as ndi

            E = cfg.expand_z
            dist_e = np.repeat(distance, E, axis=2)
            seed_e = np.repeat(seed_tile, E, axis=2)
            mask_e = np.repeat(binary, E, axis=2)
            dist_e[dist_e < cfg.distance_floor] = 0  # steep cutoffs
            if cfg.expand_mask:
                mask_e = ndi.binary_dilation(mask_e, iterations=cfg.expand_mask)
            seed_e[dist_e < cfg.seed_background_below] = 1  # background
            labels = watershed(
                -dist_e, seed_e, mask=mask_e, connectivity=cfg.connectivity,
                compactness=cfg.compactness, watershed_line=True,
            )[:, :, ::E]
        labels[labels == 1] = 0  # drop the background label

        # suppress edge-touching labels for seam-free merging
        # (segment.py:486-496)
        edge_ids = np.unique(
            np.concatenate(
                [labels[0].ravel(), labels[-1].ravel(),
                 labels[:, 0].ravel(), labels[:, -1].ravel()]
            )
        )
        labels[np.isin(labels, edge_ids)] = 0
        return labels

    def paste(x0, x1, y0, y1, labels) -> None:
        region = unique_mask[x0:x1, y0:y1, :]
        region[labels > 0] = labels[labels > 0]
        if progress:
            progress(f"watershed tile [{x0}:{x1}, {y0}:{y1}]")

    tiles = [(x0, x1, y0, y1) for x0, x1 in x_ind for y0, y1 in y_ind]
    workers = cfg.tile_workers or max(1, (os.cpu_count() or 1) - 1)
    # the tile table assumes ONE tile in flight (the reference's semantics),
    # so concurrency is capped by host RAM; an explicit cfg.tile_workers too
    workers = _cap_tile_workers(
        workers, pad, ev, Z, cfg, host_ram_bytes, concurrent_stages
    )
    if workers > 1 and len(tiles) > 1 and cfg.backend != "device":
        # floods run concurrently; results are pasted in tile order, so the
        # output equals the serial loop's.  Futures in flight are bounded by
        # the worker count, so finished label tiles cannot pile up.
        with ThreadPoolExecutor(max_workers=workers) as pool:
            it = iter(tiles)
            window: deque = deque()
            for tl in itertools.islice(it, workers):
                window.append((tl, pool.submit(flood_tile, *tl)))
            while window:
                tl, fut = window.popleft()
                labels = fut.result()
                nxt = next(it, None)
                if nxt is not None:
                    window.append((nxt, pool.submit(flood_tile, *nxt)))
                paste(*tl, labels)
    else:
        for tl in tiles:
            paste(*tl, flood_tile(*tl))

    return unique_mask, seed
