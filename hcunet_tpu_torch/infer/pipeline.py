"""End-to-end analysis pipeline (twin of ``hcunet_tpu/infer/pipeline.py``;
the ``hcat.analyze`` equivalent, ``hcat/main.py:20-236``).

Stages per chunk (the reference's numchunks×numchunks spatial grid):
 1. one host→device copy of the chunk in its source dtype (through pinned
    memory), normalized on the device;
 2. tiled 2D detection over z-planes → cell candidates;
 3. tiled 3D semantic segmentation → probability map (kernel K1 in the
    caller's ``unet_apply``), gaussian blur σ=3, floor 0.25, ×10
    (``main.py:130-132``), and the fixed-point encode for the copy back;
 4. a device→host copy into pinned memory, waited on by a CUDA event;
 5. on a tail worker: detection-seeded instance watershed, HairCell
    extraction, chunk spill to disk (resumable).
Then: reconstruct chunks, size QA render, cochlear spline fit, per-cell
tonotopic frequency, CSV.

Every chunk stage caches to a ``.npz`` journal under ``work_dir`` keyed by
chunk id, so a crashed run resumes where it stopped; the spill format is the
JAX package's.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from hcunet_tpu_torch.analysis.cochlea import get_cochlear_length
from hcunet_tpu_torch.analysis.export import cells_to_csv, render_size
from hcunet_tpu_torch.analysis.haircell import HairCell, generate_cell_objects
from hcunet_tpu_torch.config import PipelineConfig, resolve_device
from hcunet_tpu_torch.core.padding import pad_axes
from hcunet_tpu_torch.core.precision import exact_float32
from hcunet_tpu_torch.data.transforms import integer_unit_scale
from hcunet_tpu_torch.infer.candidates import empty_candidates
from hcunet_tpu_torch.infer.chunks import PART_EXT, Part, reconstruct
from hcunet_tpu_torch.infer.detect import collect_cell_candidates, dispatch_cell_candidates
from hcunet_tpu_torch.infer.instance import generate_unique_segmentation_mask
from hcunet_tpu_torch.infer.tiling import postprocess_epilogue, predict_segmentation_mask
from hcunet_tpu_torch.utils.logging import get_logger
from hcunet_tpu_torch.utils.profiling import span

log = get_logger(__name__)

_FIXED_BITS = {"uint16": 16, "uint8": 8}
_TRANSFER_DTYPES = ("float32", "bfloat16", *_FIXED_BITS)


@dataclass
class AnalyzeResult:
    mask: np.ndarray  # [X, Y, Z] semantic probability
    unique_mask: np.ndarray  # [X, Y, Z] instance labels
    cells: List[HairCell]
    cochlea_curve: Optional[np.ndarray] = None
    percentage: Optional[np.ndarray] = None
    apex: Optional[np.ndarray] = None
    # Per-stage wall time, as seen by whichever thread ran the stage.  Device
    # work and chunk tails overlap across stages, so the values bound (not
    # partition) the end-to-end wall time; ``overlap=False`` gives cleanly
    # attributable sequential stage times.
    stage_seconds: Optional[Dict[str, float]] = None
    # Bytes over the host<->device link: h2d = chunk uploads, prob_d2h =
    # probability-map fetches, detect_d2h = detection-candidate fetches.
    stage_bytes: Optional[Dict[str, int]] = None
    # Mesh-path accounting (only set by ``analyze(mesh=...)``): {"sharded":
    # chunks that rode the mesh, "fallback": chunks that ran single-device}
    mesh_chunks: Optional[Dict[str, int]] = None


class _ShardedChunkSeg:
    """Mesh-path segmentation of a chunk of any width (twin of the JAX
    ``_ShardedChunkSeg``).

    The chunk's X axis is padded up to the shard quantum ``n * eval_x`` and
    the result cropped back to ``Xc`` *before* the blur epilogue.  The
    padding repeats the single-device engine's context beyond ``Xc``: a
    ``px``-wide symmetric mirror, then edge replication (the ragged grid's
    overhang), and the extension is at least ``eval_x + pad_x`` wide, so
    no tile holding a true voxel reads the sharded engine's own far-edge
    halo.  Tiles are the same size at the same offsets in both paths, so
    every true core is computed from the same inputs, and the epilogue sees
    the single-device array.  The sharded forward is built at the first
    chunk."""

    def __init__(self, mesh, n_shards: int, unet_apply, cfg: PipelineConfig, device):
        self.mesh, self.n = mesh, int(n_shards)
        self.unet_apply, self.cfg, self.device = unet_apply, cfg, device
        self.ex = int(cfg.tiles.eval_size[0])
        self.px = int(cfg.tiles.pad[0])
        self.quantum = self.n * self.ex
        self._fn = None

    def padded_width(self, Xc: int) -> Optional[int]:
        """X after bucket padding, or None when the chunk cannot ride the
        mesh (the ``px`` mirror cannot exceed the chunk's width)."""
        if self.px > Xc:
            return None
        q = self.quantum
        Xq = -(-Xc // q) * q
        # each slab must hold at least one halo and one whole tile column
        min_xq = -(-(self.n * max(self.px, self.ex)) // q) * q
        Xq = max(Xq, min_xq)
        while 0 < Xq - Xc < self.ex + self.px:
            # one quantum may not cover a tile column and its halo when
            # pad_x > (n - 1) * eval_x
            Xq += q
        return Xq

    def __call__(self, vol: torch.Tensor, Xq: int) -> torch.Tensor:
        if self._fn is None:
            from hcunet_tpu_torch.parallel.tiled import sharded_tiled_forward

            self._fn = sharded_tiled_forward(
                self.unet_apply, self.mesh, self.cfg.unet, self.cfg.tiles,
                use_probability_map=True, postprocess=None,
            )
        Xc = int(vol.shape[1])
        if Xq > Xc:
            vol = pad_axes(vol, [(0, self.px), (0, 0), (0, 0)], "symmetric")
            vol = pad_axes(vol, [(0, Xq - Xc - self.px), (0, 0), (0, 0)], "edge")
        prob = self._fn(vol)[:, :Xc].to(self.device)
        cfg = self.cfg
        return postprocess_epilogue(prob, (cfg.gaussian_sigma, cfg.prob_floor, cfg.prob_scale))


def _load_volume(path: str) -> np.ndarray:
    """Load a z-stack to [X, Y, Z, C].

    Integer stacks (uint8/uint16 TIFFs, the production case) keep their
    dtype: the [0,1] rescale happens on the device inside the pipeline's
    normalize, so the volume is copied at its native width.  Float inputs
    are brought to [0,1]."""
    from hcunet_tpu_torch.data.tiff import imread
    from hcunet_tpu_torch.data.transforms import reshape, to_float

    raw = imread(path)  # [Z, Y, X, C] skimage convention
    if raw.ndim == 3:
        raw = raw[..., None]
    if not np.issubdtype(raw.dtype, np.integer):
        raw = to_float()(raw)
    return reshape()(raw)


def _nbytes(t) -> int:
    return int(t.numel()) * t.element_size()


def _encode_fixed(prob: torch.Tensor, scale: float, bits: int) -> torch.Tensor:
    """Fixed-point encode over the epilogue's static ``[0, scale]`` range,
    rounding half to even like ``jnp.round``: uint16 (max error
    scale/131070) or uint8 (scale/510).  The 16-bit code comes back as the
    uint16 bit pattern in an int16 tensor (torch's uint16 has few CUDA
    ops); the host views it as uint16."""
    qmax = float(2**bits - 1)
    q = torch.round(torch.clamp(prob * (qmax / scale), 0.0, qmax))
    if bits == 8:
        return q.to(torch.uint8)
    return q.to(torch.int32).to(torch.int16)


def _upload(host: np.ndarray, dev: torch.device) -> torch.Tensor:
    """The chunk's one host→device copy, in its source dtype: a uint16 chunk
    travels as its int16 view (widened on the device), float64 as float32
    (as the JAX package's upload converts it).  On CUDA the copy goes
    through pinned memory and does not block."""
    if host.dtype == np.uint16:
        host = host.view(np.int16)
    elif host.dtype == np.float64:
        host = host.astype(np.float32)
    src = torch.from_numpy(host)
    if dev.type != "cuda":
        return src.to(dev)
    return src.pin_memory().to(dev, non_blocking=True)


def _normalize(raw: torch.Tensor, src_dtype: np.dtype, mean, std) -> torch.Tensor:
    """float32 ``(x - mean) / std`` on the device, integer sources first
    divided by :func:`integer_unit_scale`, in the JAX package's operation
    order (``pipeline.py:394-404``)."""
    if src_dtype == np.uint16:
        x = (raw.to(torch.int32) & 0xFFFF).to(torch.float32)  # exact widening
    else:
        x = raw.to(torch.float32)
    if np.issubdtype(src_dtype, np.integer):
        x = x / integer_unit_scale(src_dtype)
    mean_t = torch.from_numpy(np.asarray(mean, np.float32)).to(raw.device)
    std_t = torch.from_numpy(np.asarray(std, np.float32)).to(raw.device)
    return (x - mean_t) / std_t


def _copy_to_host(t: torch.Tensor) -> torch.Tensor:
    """Start a device→host copy of ``t`` into pinned memory; a CPU tensor is
    returned as it is.  Read the copy only after :func:`_copy_event`'s event
    has completed: before, the pinned buffer holds garbage."""
    if t.device.type == "cpu":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def _copy_event(dev: torch.device):
    """A CUDA event behind the work enqueued so far on ``dev``'s current
    stream (None on the CPU, where nothing is in flight)."""
    if dev.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record()
    return event


def analyze(
    path: Optional[str] = None,
    volume: Optional[np.ndarray] = None,
    *,
    unet_apply: Callable,
    detector=None,
    cfg: PipelineConfig = PipelineConfig(),
    work_dir: str = "./hcunet_work",
    save_plots: bool = False,
    fit_cochlea: bool = True,
    overlap: Optional[bool | int] = None,
    mesh=None,
    device=None,
) -> AnalyzeResult:
    """Analyze one cochlea z-stack.

    Provide either ``path`` (tif/npy on disk) or ``volume`` ([X, Y, Z, C]:
    float in [0,1], or uint8/uint16 raw, copied to the device at native
    width and rescaled to [0,1] there).  ``unet_apply`` maps a tile batch
    ``[B, tx, ty, tz, C]`` on the device to logits
    (:func:`hcunet_tpu_torch.infer.compile.compile_serving_apply`).
    ``detector`` is a :class:`~hcunet_tpu_torch.models.detection.Detector`
    holding its weights, on ``device``; None skips detection (instance
    masks then come back empty).  ``device`` is CUDA unless given.

    ``overlap`` runs the host tail of chunk k (detection merge, instance
    watershed, cell objects, spill) on worker threads while chunk k+1 runs
    on the device (the host flood releases the GIL).  A bool (True → one
    worker) or a worker count; chunk tails are independent and ``pending``
    keeps chunk order, so the results do not depend on it.  Default: one
    worker.  The device work of a chunk is dispatched before the previous
    chunk's results are read (a 1-deep software pipeline); the detector's
    NMS reads one convergence flag per step, so detection waits for the
    device.

    ``mesh`` (a :class:`~hcunet_tpu_torch.parallel.mesh.Mesh` with a
    ``spatial`` axis) segments each chunk over the mesh: its X axis split
    over the ``spatial`` devices with halos copied between neighbours
    (:func:`~hcunet_tpu_torch.parallel.tiled.sharded_tiled_forward`), the
    U-Net's forward replicated to each of them
    (:func:`~hcunet_tpu_torch.parallel.mesh.replicate`).  Every chunk rides
    the mesh whatever its width: it is bucket-padded to the shard quantum
    and cropped back before the blur, which keeps the result equal to the
    single-device one (:class:`_ShardedChunkSeg`); a chunk thinner than
    the halo runs single-device with a warning, counted in
    ``AnalyzeResult.mesh_chunks``.  Detection splits each tile's z planes
    over every mesh device (:class:`~hcunet_tpu_torch.infer.detect.ShardedDetect`).
    The instance stage and the host tail stay on ``device`` (by default the
    mesh's first ``spatial`` device), as in JAX.

    Float32 work runs with TF32 off (:func:`~hcunet_tpu_torch.core.precision.exact_float32`).
    """
    with exact_float32():
        return _analyze(path, volume, unet_apply=unet_apply, detector=detector, cfg=cfg,
                        work_dir=work_dir, save_plots=save_plots, fit_cochlea=fit_cochlea,
                        overlap=overlap, mesh=mesh, device=device)


def _analyze(path, volume, *, unet_apply, detector, cfg, work_dir, save_plots,
             fit_cochlea, overlap, mesh, device) -> AnalyzeResult:
    if cfg.prob_transfer_dtype not in _TRANSFER_DTYPES:
        raise ValueError(f"unknown prob_transfer_dtype {cfg.prob_transfer_dtype!r}")
    sharded_seg = None
    mesh_chunks: Optional[Dict[str, int]] = None
    if mesh is not None:
        from hcunet_tpu_torch.infer.detect import ShardedDetect
        from hcunet_tpu_torch.parallel.mesh import SPATIAL_AXIS, require_mesh

        if SPATIAL_AXIS not in require_mesh(mesh).axis_names:
            raise ValueError(f"mesh {mesh.axis_names} has no '{SPATIAL_AXIS}' axis")
        if device is None:
            device = mesh.axis_devices(SPATIAL_AXIS)[0]
    dev = resolve_device(device)
    if mesh is not None:
        sharded_seg = _ShardedChunkSeg(
            mesh, int(mesh.shape[SPATIAL_AXIS]), unet_apply, cfg, dev
        )
        mesh_chunks = {"sharded": 0, "fallback": 0}
        if detector is not None:
            detector = ShardedDetect(detector, mesh, device=dev)
    if overlap is None:
        overlap = True
    if isinstance(overlap, bool):
        tail_workers = 1 if overlap else 0
    else:
        tail_workers = max(0, int(overlap))

    os.makedirs(work_dir, exist_ok=True)

    if volume is None:
        if path is None:
            raise ValueError("provide path or volume")
        log.info("loading image %s", path)
        volume = _load_volume(path)
    X, Y, Z, C = volume.shape

    # journal fingerprint: a reused work_dir must belong to this exact
    # volume + chunking, or cached chunks would silently mix images.
    _check_journal_fingerprint(work_dir, volume, cfg.numchunks)
    mean = np.asarray(cfg.normalize_mean[:C])
    std = np.asarray(cfg.normalize_std[:C])

    n = cfg.numchunks
    y_ind = np.linspace(0, Y, n).astype(int)
    x_ind = np.linspace(0, X, n).astype(int)

    all_cells: List[HairCell] = []
    t_start = time.perf_counter()
    stage_seconds = {"detect": 0.0, "unet": 0.0, "instance": 0.0, "analytics": 0.0}
    stage_bytes = {"h2d": 0, "prob_d2h": 0, "detect_d2h": 0}
    # chunk tails run on worker threads: the read-modify-write
    # accumulations take a lock
    acct_lock = threading.Lock()

    class _staged:
        """A stage's time into ``stage_seconds`` and, while a profiler
        collects, its span ``hcunet.analyze.<stage>`` in the trace."""

        def __init__(self, name):
            self.name = name
            self.span = span(f"hcunet.analyze.{name}")

        def __enter__(self):
            self.span.__enter__()
            self.t0 = time.perf_counter()

        def __exit__(self, *exc):
            dt = time.perf_counter() - self.t0
            with acct_lock:
                stage_seconds[self.name] += dt
            return self.span.__exit__(*exc)

    def _count_bytes(key, nb):
        with acct_lock:
            stage_bytes[key] += nb

    def _finish_chunk(chunk_id, chunk, det_host, prob, cx0, cy0,
                      part_path, cells_path, raw_prob=None, raw_scale=None):
        """Host tail of one chunk: detection merge, instance watershed, cell
        objects, spill.  Runs on a tail worker when ``overlap`` is on."""
        if det_host is not None:
            det_pending, det_event = det_host
            with _staged("detect"):
                if det_event is not None:
                    det_event.synchronize()
                candidates = collect_cell_candidates(det_pending)
            log.info("%s: %d candidates", chunk_id, len(candidates["scores"]))
        else:
            candidates = empty_candidates()
        with _staged("instance"):
            unique_mask, _seed = generate_unique_segmentation_mask(
                prob, candidates, cfg.watershed,
                # N chunk tails flood concurrently: each pool's RAM share
                # shrinks so the aggregate stays within the budget
                concurrent_stages=max(1, tail_workers),
                device=dev,
            )
        cells = generate_cell_objects(chunk, unique_mask, x_ind_chunk=cx0, y_ind_chunk=cy0)
        # fixed-point sources spill raw (the bytes that crossed the link;
        # reconstruct dequantizes at the paste, bit-identical to spilling
        # the dequantized float32)
        part = (
            Part.create(raw_prob, unique_mask, (cx0, cy0), mask_scale=raw_scale)
            if raw_prob is not None
            else Part.create(prob, unique_mask, (cx0, cy0))
        )
        part.save(part_path, compress=cfg.spill_compress)
        _save_cells(cells_path, cells)
        log.info(
            "%s done: %d cells (%.1fs elapsed)",
            chunk_id, len(cells), time.perf_counter() - t_start,
        )
        return cells

    def _dispatch_chunk(item):
        """The chunk's one upload and the dispatch of both device stages;
        the detector's channels are sliced from the same device tensor.
        Returns the in-flight chunk for :func:`_collect_chunk`."""
        chunk_id, cx0, cx1, cy0, cy1, part_path, cells_path = item
        chunk = volume[cx0:cx1, cy0:cy1]
        host = np.ascontiguousarray(chunk)[None]
        raw = _upload(host, dev)
        _count_bytes("h2d", _nbytes(raw))
        vol = _normalize(raw, host.dtype, mean, std)  # [1, X, Y, Z, C] float32
        del raw

        det_host = None
        if detector is not None:
            with _staged("detect"):
                pending = dispatch_cell_candidates(
                    vol[0][..., list(cfg.detection_channels)], detector, device=dev
                )
                # copy the detections back without blocking, in the JAX
                # package's dtypes (int32 labels): the tail waits on their
                # event only, not on the next chunk's device work
                fetched = []
                for *tile, out in pending:
                    out = {**out, "labels": out["labels"].to(torch.int32)}
                    keys = ("boxes", "scores", "labels", "valid")
                    _count_bytes("detect_d2h", sum(_nbytes(out[k]) for k in keys))
                    fetched.append((*tile, {k: _copy_to_host(out[k]) for k in keys}))
                det_host = (fetched, _copy_event(dev))

        with _staged("unet"):
            Xc = chunk.shape[0]
            Xq = sharded_seg.padded_width(Xc) if sharded_seg is not None else None
            if Xq is not None:
                mesh_chunks["sharded"] += 1
                prob_dev = sharded_seg(vol, Xq)
            else:
                if sharded_seg is not None:
                    mesh_chunks["fallback"] += 1
                    log.warning(
                        "%s: chunk X=%d too thin to bucket-pad to the shard quantum %d; "
                        "running single-device", chunk_id, Xc, sharded_seg.quantum,
                    )
                prob_dev = predict_segmentation_mask(
                    unet_apply, vol, cfg.unet, cfg.tiles,
                    use_probability_map=True,
                    postprocess=(cfg.gaussian_sigma, cfg.prob_floor, cfg.prob_scale),
                    device=dev,
                )
            del vol
            if cfg.prob_transfer_dtype == "bfloat16":
                prob_dev = prob_dev.to(torch.bfloat16)
            elif cfg.prob_transfer_dtype in _FIXED_BITS:
                prob_dev = _encode_fixed(
                    prob_dev, cfg.prob_scale, _FIXED_BITS[cfg.prob_transfer_dtype]
                )
            # start the device→host copy as soon as the map is enqueued
            prob_host = _copy_to_host(prob_dev)
            prob_event = _copy_event(dev)
        return (chunk_id, chunk, det_host, prob_host, prob_event, cx0, cy0,
                part_path, cells_path)

    def _collect_chunk(flight):
        """Wait for the in-flight chunk's probability map and hand the chunk
        to its tail."""
        (chunk_id, chunk, det_host, prob_t, prob_event, cx0, cy0,
         part_path, cells_path) = flight
        with _staged("unet"):
            if prob_event is not None:
                prob_event.synchronize()  # the pinned buffer holds the map
            _count_bytes("prob_d2h", _nbytes(prob_t))
            raw_prob, raw_scale = None, None
            if cfg.prob_transfer_dtype in _FIXED_BITS:
                # keep the raw fixed-point map: the spill stores it at the
                # link's width instead of re-inflating to float32
                raw_prob = prob_t.numpy()[0, ..., 0]
                if raw_prob.dtype == np.int16:
                    raw_prob = raw_prob.view(np.uint16)
                raw_scale = cfg.prob_scale / float(
                    2 ** _FIXED_BITS[cfg.prob_transfer_dtype] - 1
                )
                prob = raw_prob.astype(np.float32)
                prob *= np.float32(raw_scale)
            else:
                prob = prob_t[0, ..., 0].float().numpy()

        args = (chunk_id, chunk, det_host, prob, cx0, cy0,
                part_path, cells_path, raw_prob, raw_scale)
        if executor is not None:
            fut = executor.submit(_finish_chunk, *args)
            pending.append(fut)
            # backpressure: each queued tail holds its chunk's maps until it
            # runs, so incomplete tails are bounded to workers + 1; blocking
            # the main thread here throttles further dispatch
            live.append(fut)
            while len(live) > tail_workers + 1:
                live.popleft().result()
        else:
            pending.append(_finish_chunk(*args))

    executor = ThreadPoolExecutor(max_workers=tail_workers) if tail_workers else None
    pending = []  # per chunk: a cells list (cached/sequential) or a Future
    live: deque = deque()  # submitted tails not yet known to be finished
    inflight = None  # the chunk whose device work is dispatched, not read yet
    try:
        for i in range(1, len(y_ind)):
            for j in range(1, len(x_ind)):
                cx0, cx1 = int(x_ind[j - 1]), int(x_ind[j])
                cy0, cy1 = int(y_ind[i - 1]), int(y_ind[i])
                chunk_id = f"chunk_{i}_{j}"
                part_path = os.path.join(work_dir, chunk_id + PART_EXT)
                cells_path = os.path.join(work_dir, chunk_id + ".cells.npz")
                if os.path.exists(part_path) and os.path.exists(cells_path):
                    if inflight is not None:  # keep chunk order in `pending`
                        _collect_chunk(inflight)
                        inflight = None
                    log.info("%s cached — skipping", chunk_id)
                    pending.append(_load_cells(cells_path))
                    continue

                flight = _dispatch_chunk(
                    (chunk_id, cx0, cx1, cy0, cy1, part_path, cells_path)
                )
                if inflight is not None:
                    _collect_chunk(inflight)
                inflight = flight
        if inflight is not None:
            _collect_chunk(inflight)
        for item in pending:
            all_cells.extend(item.result() if hasattr(item, "result") else item)
    finally:
        if executor is not None:
            executor.shutdown(wait=True)

    log.info("reconstructing masks")
    with _staged("analytics"):
        mask, unique_mask = reconstruct(work_dir)  # one pass over the spills

        if save_plots:
            render_size(unique_mask, os.path.join(work_dir, "size_validation.tif"))

        curve = pct = apex = None
        if fit_cochlea:
            log.info("fitting cochlear spline")
            projected = (mask > 0.5).sum(-1) if mask.dtype != np.uint8 else mask.sum(-1)
            try:
                curve, pct, apex = get_cochlear_length(
                    projected.astype(np.float64), equal_spaced_distance=2
                )
                for cell in all_cells:
                    cell.set_frequency(curve, pct)
            except ValueError as e:
                log.warning("cochlear fit failed: %s", e)

        cells_to_csv(all_cells, os.path.join(work_dir, "cells.csv"))
    log.info(
        "stage seconds: %s  transfer bytes: %s",
        {k: round(v, 2) for k, v in stage_seconds.items()},
        {k: f"{v / 1e6:.1f}MB" for k, v in stage_bytes.items()},
    )
    return AnalyzeResult(
        mask, unique_mask, all_cells, curve, pct, apex, stage_seconds, stage_bytes,
        mesh_chunks,
    )


def _volume_fingerprint(volume: np.ndarray, numchunks: int) -> str:
    import hashlib

    h = hashlib.sha1()
    h.update(str((volume.shape, str(volume.dtype), numchunks)).encode())
    # sample a deterministic sparse stride of the data — cheap but catches
    # a different image in the same-shaped container
    flat = volume.reshape(-1)
    h.update(np.ascontiguousarray(flat[:: max(1, flat.size // 4096)]).tobytes())
    return h.hexdigest()


def _check_journal_fingerprint(work_dir: str, volume: np.ndarray, numchunks: int):
    import json

    fp = _volume_fingerprint(volume, numchunks)
    path = os.path.join(work_dir, "journal.json")
    if os.path.exists(path):
        with open(path) as f:
            recorded = json.load(f).get("fingerprint")
        if recorded != fp:
            raise ValueError(
                f"work_dir {work_dir!r} holds a journal for a different "
                f"volume/chunking — use a fresh work_dir or delete it"
            )
    else:
        if any(f.endswith(PART_EXT) for f in os.listdir(work_dir)):
            raise ValueError(
                f"work_dir {work_dir!r} has chunk parts but no journal — "
                f"refusing to mix; use a fresh work_dir"
            )
        with open(path, "w") as f:
            json.dump({"fingerprint": fp, "numchunks": numchunks,
                       "shape": list(volume.shape)}, f)


def _save_cells(path: str, cells: List[HairCell]) -> None:
    import pickle

    blob = [
        {
            "image_coords": c.image_coords,
            "center": c.center,
            "unique_id": c.unique_id,
            "volume": c.volume,
            "is_bad": c.is_bad,
            "signal_stats": c.signal_stats,
            "gfp_stats": c.gfp_stats,
        }
        for c in cells
    ]
    np.savez_compressed(path, blob=np.frombuffer(pickle.dumps(blob), np.uint8))


def _load_cells(path: str) -> List[HairCell]:
    import pickle

    with np.load(path) as z:
        blob = pickle.loads(z["blob"].tobytes())
    cells = []
    for d in blob:
        c = HairCell(
            d["image_coords"], d["center"], d["unique_id"],
            is_bad=d["is_bad"], volume=d["volume"],
        )
        c.signal_stats = d["signal_stats"]
        c.gfp_stats = d["gfp_stats"]
        cells.append(c)
    return cells
