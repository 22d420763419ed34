#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``hcunet_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU and the CUDA
toolkit::

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --phases k1     # build K1 and run phase 3 alone

``--phases`` takes a comma-separated subset of ``k1`` (3), ``k3`` (4),
``slice1`` (5), ``k2`` (6), ``slice2`` (7), ``blobs`` (8), ``train`` (9)
and ``slice3`` (10); phases 1, 2 (only the kernels the chosen phases
launch) and 11 always run.  A run of fewer than all phases reports no
launch counts (they are the whole main path's) and ends with
``{"partial": true, "phases": [...], ...}`` instead of the result line.
Phases (any failure exits non-zero):

1. print the card (``nvidia-smi`` name and power limit) and turn TF32 off;
2. build kernels K1 (``hcunet_tpu_torch/csrc/conv3d_valid.cu``), K2
   (``csrc/edt_pass.cu``) and K3 (``csrc/dot_blocked.cu``) into ``build/``,
   one ``nvcc`` each, all together, and the host flood
   (``csrc/watershed_host.cpp``) with ``g++`` beside them;
3. hold K1 against its plain version at the 15 valid-conv shapes of the
   production U-Net's serving forward at the tile geometry the port picks
   for this card, plus the TPU probe's case 1, in bfloat16 and float32,
   timing the kernel, the plain version and cuDNN's ``F.conv3d``; each row
   names K1's path (``k1_route``: ``ring`` or ``basic``), and the sums over
   the 15 layers and over the ring layers are printed beside cuDNN's and
   the bound's;
4. hold K3 against its plain version at the TPU probe's two shapes and at
   the GEMM shape (M, K, N) of each of the 15 K1 layers (a random dense A),
   in bfloat16 and float32, timing the kernel, the plain version and
   ``torch.matmul``; each row names K3's path (``k3_route``), which must be
   the ring at both probe cases and at every bf16 layer GEMM but
   ``out_conv``'s (N = 1), the basic path elsewhere; print the sums over
   the 15 layer GEMMs beside cuBLAS and the bound, and K3's time over K1's
   per layer;
5. slice 1's path: ``Segmenter.predict`` on ``UNetConfig.production_3d()``
   at full width (random He-normal weights and random batch-norm statistics
   from a seed) for three requests, checking that every tile batch launched
   K1 15 times (in bfloat16 14 on the ring path, the 4-channel first conv
   on the basic one), and that the float32 request agrees with a forward
   built on the plain conv;
6. hold K2 against its plain version, exactly, at the instance tile
   [1323, 1323, 15] of the main path, the TPU probe's 412^2 x 12 and
   1212^2 x 8, and a ragged shape, on a random mask, and at the first two
   on a sparse background and on the blob mask, timing both passes of
   each;
7. slice 2's path on the bench scene (2304, 2304, 15, 4): the uint8 mask
   from ``Segmenter(use_probability_map=False)``, candidates from
   ``predict_cell_candidates`` with a full-width ResNet50-FPN ``Detector``
   (random weights from a seed) on 9 tile positions of 1047^2 x 15 planes,
   and ``generate_unique_segmentation_mask(backend="device")`` on 4 instance
   tiles, checking that K2 launched 8 times and K1 15 per tile batch; then
   the instance stage once more under ``torch.profiler``;
8. the instance stage on a synthetic blob scene of one full tile: labels
   with K2 equal to labels with the plain EDT, and >= 90 % of the seeded
   blobs found;
9. training (slice 8's path): the JAX bench's fit
   (``hcunet_tpu/benchmarks.py:342-423``) through ``UNetTrainer`` at the
   full width of ``UNetConfig.production_3d()`` in bfloat16 (weights from
   the seed): 40 steps of Adam(3e-3) with ``cross_entropy(method="pixel")``
   on the 256^2 x 12 crop of the pipeline scene, each step launching K1 15
   times in the forward (14 on the ring path) and 14 times for the input
   gradient (13 on the ring path; none for the first layer), the loss
   falling; 3 steps with K1 against 3 with the plain conv, in float32 and
   in bfloat16, parameters and batch statistics within the tolerances of
   ``trajectory_gap``; K1's input gradient against its plain version at
   the fit's 14 layer shapes in bfloat16 and float32, timed beside cuDNN's
   dgrad and the bound; and the fitted weights through ``trainer.save`` and
   ``Segmenter.from_checkpoint``, whose prediction on the 1152^2 x 15
   request must equal that of a ``Segmenter`` on ``trainer.variables``;
10. slice 3's path, ``analyze`` on the JAX bench's pipeline scene (1536 x
   1536 x 12, uint16, 160 blob cells; ``numchunks=3``, the auto tile
   geometry, the uint16 transfer, the ``"fused"`` host flood): a warm-up
   of the device stages on one chunk, a timed run (K1 15 launches per tile
   batch), a resume from its journal
   (K1 0 launches, the same cells), a float32-transfer run without overlap
   under ``torch.profiler`` whose mask the uint16 run's must match within
   one half quantum, and the ``"fused"`` and ``"materialized"`` backends on
   one chunk's map, which must give equal labels; on the fitted weights
   of phase 9 where it ran (as the JAX bench does), else on the random
   ones;
11. print one JSON line of kernel rows (``launches``: the count over the
    paths, slices 1-3 and training, with ``launches_by_path`` beside it;
    K1's input-gradient rows count the training path's input-gradient
    launches), the card line, and the result line.

Imports only ``hcunet_tpu_torch``, torch and numpy.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

H100_BF16_FLOPS = 989e12  # dense tensor-core peak, H100 SXM data sheet
H100_F32_FLOPS = 67e12    # float32 outside the tensor cores (TF32 is off)
H100_F64_FLOPS = 34e12    # float64 outside the tensor cores, H100 SXM data sheet
H100_BYTES_PER_S = 3.35e12
SEED = 0
REQUESTS = [(1152, 1152, 15), (1000, 900, 15), (2304, 2304, 15)]
BENCH_SCENE = (2304, 2304, 15)
# host RAM the instance stage sizes its tiles for: >= 16 GB gives the
# reference's 1212 + 2*56 tiles, 4 of them over the bench scene
INSTANCE_HOST_RAM = 32 * 2**30
INSTANCE_TILE = (1323, 1323, 15)
# K2's check shapes: the main path's instance tile, the TPU probe's two
# (scripts/probe_edt_device.py) and a ragged one
EDT_SHAPES = [INSTANCE_TILE, (412, 412, 12), (1212, 1212, 8), (517, 1301, 7)]
# and two inputs that stress the envelope (edt_mask) at two of them
EDT_STRESS = [(shape, kind) for shape in EDT_SHAPES[:2] for kind in ("sparse", "blobs")]
PROBE_CASE_1 = ((6, 494, 494, 3, 128), (3, 3, 2, 128, 128))
# K3's TPU probe shapes (scripts/probe_pallas_dot.py:78-81): x [B, X, Y, K], N
DOT_PROBE_CASES = [("probe_case_1", (12, 492, 494, 768), 384),
                   ("probe_case_2", (6, 492, 494, 2304), 128)]
# a layer GEMM's dense A is cut into slices of at most this many elements
# (the largest, up2.conv1, is 1.3e10); one A slice is reused for all of them
DOT_SLICE_ELEMS = 2**31
# the JAX bench's pipeline scene (hcunet_tpu/benchmarks.py:498-499)
PIPELINE_SCENE = (1536, 1536, 12)
PIPELINE_CELLS = 160
LAYER_NAMES = (
    [f"down{i}.conv{j}" for i in range(4) for j in (1, 2)]
    + [f"up{i}.conv{j}" for i in range(3) for j in (1, 2)]
    + ["out_conv"]
)
# the JAX bench's fit (hcunet_tpu/benchmarks.py:342-423): the 256^2 crop of
# the pipeline scene, 40 Adam steps at 3e-3; and the steps of the parity runs
FIT_CROP = 256
FIT_STEPS = 40
FIT_LR = 3e-3
PARITY_STEPS = 3


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean device time of ``fn()`` in ms over ``reps`` runs after one warm-up,
    from CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def build_model(cfg, gen):
    """production U-Net with He-normal weights and random, non-trivial
    batch-norm statistics and affine parameters, all from ``gen``."""
    from hcunet_tpu_torch.models.unet import init_unet

    model = init_unet(cfg, gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm3d):
                m.weight.copy_(torch.rand(m.weight.shape, generator=gen) + 0.5)
                m.bias.copy_(torch.randn(m.bias.shape, generator=gen) * 0.1)
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=gen) + 0.5)
    return model


def record_layers(model, tile_cfg, dev):
    """Run one tile batch through the serving forward with a recording plain
    conv (no kernel launch) and return the 15 convs' (shape of x, folded
    weights, bias, relu) in the order the main path runs them."""
    from hcunet_tpu_torch.infer.compile import compile_serving_apply
    from hcunet_tpu_torch.ops.conv import conv3d_valid_plain

    layers = []

    def recording_conv(x, w, b, relu):
        layers.append((tuple(x.shape), w, b, relu))
        return conv3d_valid_plain(x, w, b, relu)

    tile_in = [e + 2 * p for e, p in zip(tile_cfg.eval_size, tile_cfg.pad)]
    apply = compile_serving_apply(
        model, dtype=torch.bfloat16, device=dev, conv=recording_conv
    )
    apply(torch.zeros((tile_cfg.batch, *tile_in, model.config.in_channels), device=dev))
    if len(layers) != len(LAYER_NAMES):
        raise RuntimeError(f"expected 15 valid convs, recorded {len(layers)}")
    return layers


def kernel_error(got, want) -> tuple[float, float]:
    """A K1 or K3 result's max error against the plain version's, and its
    tolerance.  float32: both sum in float32 in different orders.  bfloat16:
    both round the float32 sum once, so they differ by at most one bf16 ulp
    (2^-7 relative) where the sums straddle a rounding boundary."""
    scale = max(1.0, float(want.float().abs().max()))
    tol = 1e-5 * scale if want.dtype == torch.float32 else 2.0**-7 * scale
    return float((got.float() - want.float()).abs().max()), tol


def check_kernel(name, x, w, b, relu):
    """K1 against its plain version on one input (``w`` in ``x``'s dtype);
    returns a row."""
    from hcunet_tpu_torch.ops.conv import (
        CONV3D_VALID,
        conv3d_valid,
        conv3d_valid_plain,
        conv3d_valid_route,
    )

    dtype, x_shape = x.dtype, tuple(x.shape)
    k1_route = conv3d_valid_route(dtype, w.shape[3], w.shape[4])
    before = dict(CONV3D_VALID.route_launches)
    got = conv3d_valid(x, w, b, relu)
    taken = [r for r, n in CONV3D_VALID.route_launches.items() if n != before[r]]
    if taken != [k1_route]:
        raise AssertionError(f"{name}: K1 took the path(s) {taken}, expected {k1_route}")
    want = conv3d_valid_plain(x, w, b, relu)
    torch.cuda.synchronize()
    err, tol = kernel_error(got, want)
    del got, want

    x_cf = x.permute(0, 4, 1, 2, 3)
    w_cf = w.permute(4, 3, 0, 1, 2)
    b_lib = b.to(dtype)
    kernel_ms = cuda_ms(lambda: conv3d_valid(x, w, b, relu))
    plain_ms = cuda_ms(lambda: conv3d_valid_plain(x, w, b, relu))
    library_ms = cuda_ms(lambda: torch.nn.functional.conv3d(x_cf, w_cf, b_lib))

    kx, ky, kz, cin, cout = w.shape
    out_vox = x_shape[0] * (x_shape[1] - kx + 1) * (x_shape[2] - ky + 1) * (x_shape[3] - kz + 1)
    es = x.element_size()
    flops = 2.0 * out_vox * kx * ky * kz * cin * cout
    nbytes = (x.numel() + w.numel() + out_vox * cout) * es + b.numel() * 4
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    dt = "bf16" if dtype == torch.bfloat16 else "f32"
    row = {
        "name": f"conv3d_valid[{name},{dt}]",
        "route": "cuda",
        "k1_route": k1_route,
        "source": "hcunet_tpu_torch/csrc/conv3d_valid.cu",
        "replaces": "scripts/probe_pallas_conv.py:228",
        "launches": None,
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
    }
    print(
        f"  {row['name']:34s} {k1_route:5s} x{list(x_shape)} w{list(w.shape)} err {err:.3e} "
        f"(tol {tol:.3e}) kernel {kernel_ms:8.3f} ms plain {plain_ms:8.3f} ms "
        f"cudnn {library_ms:8.3f} ms bound {row['bound_ms']:7.3f} ms "
        f"({row['bound_by']}, {flops / kernel_ms / 1e9:.1f} TFLOP/s)",
        flush=True,
    )
    if not err <= tol:
        raise AssertionError(f"{row['name']}: max error {err} > tolerance {tol}")
    return row


def k1_sums(rows) -> None:
    """K1 over the 15 layers and over the layers on the ring path, per
    dtype, beside cuDNN and the bound."""
    for dt in ("bf16", "f32"):
        layer = [r for r in rows if r["name"] in {f"conv3d_valid[{n},{dt}]" for n in LAYER_NAMES}]
        for label, sel in (("15 layers", layer),
                           ("ring layers", [r for r in layer if r["k1_route"] == "ring"])):
            if not sel:
                continue
            ms, lib, bound = (sum(r[k] for r in sel) for k in ("ms", "library_ms", "bound_ms"))
            print(f"K1 {dt}, {label} ({len(sel)}): kernel {ms:.3f} ms, cuDNN {lib:.3f} ms "
                  f"(kernel/cuDNN {ms / lib:.3f}), bound {bound:.3f} ms (kernel at "
                  f"{100 * bound / ms:.1f}% of it)", flush=True)


def n_tile_batches(seg, spatial) -> int:
    bucket = seg.bucket_shape(spatial)
    ev = [min(e, s) for e, s in zip(seg.tile_cfg.eval_size, bucket)]
    tiles = math.prod(-(-s // e) for s, e in zip(bucket, ev))
    return -(-tiles // seg.tile_cfg.batch)


def reset_counts(kernels) -> None:
    """Every launch count (and K1's count by path) to 0."""
    for k in kernels:
        k.launches = 0
        k.route_launches = dict.fromkeys(k.route_launches, 0)


def check_k1_routes(route_launches, batches, dtype) -> None:
    """Each tile batch runs 14 convs on K1's ring path and the 4-channel
    first one on the basic path in bfloat16, all 15 on the basic path in
    float32."""
    ring = 14 * batches if dtype == torch.bfloat16 else 0
    want = {"basic": 15 * batches - ring, "ring": ring}
    if route_launches != want:
        raise AssertionError(f"K1 routes {route_launches}, expected {want}")


def run_request(seg, vol, kernel) -> tuple[np.ndarray, float, int, int]:
    """One ``predict`` with the launch count set to 0 just before it.
    Returns the probabilities, seconds, launches and peak device bytes."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts([kernel])
    t0 = time.perf_counter()
    out = seg.predict(vol)
    sec = time.perf_counter() - t0
    launches = kernel.launches
    peak = torch.cuda.max_memory_allocated()
    batches = n_tile_batches(seg, vol.shape[:-1])
    want = 15 * batches
    if launches != want:
        raise AssertionError(f"K1 launched {launches} times, expected {want}")
    check_k1_routes(kernel.route_launches, batches, seg.model.dtype)
    if out.shape != vol.shape[:-1] or not np.isfinite(out).all():
        raise AssertionError(f"bad output {out.shape} for {vol.shape}")
    if out.min() < 0 or out.max() > 1:
        raise AssertionError(f"probabilities outside [0, 1]: {out.min()} {out.max()}")
    return out, sec, launches, peak


def profile_device(label: str, fn, kernels):
    """Run ``fn()`` once under ``torch.profiler``: device time by kernel, the
    device's busy share of the wall time, and the share of each kernel in
    ``kernels`` (``{name: symbol substring}``).  Returns ``fn()``'s result."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        rows.append((us, ev.count, ev.key))
    busy = sum(r[0] for r in rows)
    if busy == 0:
        print(f"profile of {label}: device time not measured (no device events)")
        return result
    shares = ", ".join(
        f"{name} {sum(r[0] for r in rows if sym in r[2]) / 1e3:.1f} ms "
        f"({100 * sum(r[0] for r in rows if sym in r[2]) / busy:.1f}% of device time)"
        for name, sym in kernels.items()
    )
    print(
        f"profile of {label}: wall {wall_us / 1e3:.1f} ms, device busy "
        f"{busy / 1e3:.1f} ms ({100 * busy / wall_us:.1f}%, idle "
        f"{100 * (1 - busy / wall_us):.1f}%)" + (f", {shares}" if shares else "")
    )
    for us, count, key in sorted(rows, reverse=True)[:12]:
        print(f"  {us / 1e3:9.2f} ms {count:5d}x  {key[:110]}")
    return result


def edt_mask(shape, kind, dev):
    """K2's check input (nonzero = foreground): ``random`` (60 % foreground,
    background at [0, 0, :] in every slice, the last slice all foreground:
    distance 1e6), ``sparse`` (4 background voxels per slice: distances run
    to about n and the envelopes are short) or ``blobs`` (``blob_scene``'s
    cell mask)."""
    if kind == "random":
        gen = torch.Generator(device=dev).manual_seed(SEED)
        b = torch.rand(shape, generator=gen, device=dev) > 0.4
        b[0, 0, :] = False
        b[..., -1] = True
        return b
    rng = np.random.default_rng(SEED)
    if kind == "blobs":
        return torch.from_numpy(blob_scene(rng, shape)[0] != 0).to(dev)
    b = np.ones(shape, bool)
    for z in range(shape[-1]):
        b[rng.integers(shape[0], size=4), rng.integers(shape[1], size=4), z] = False
    return torch.from_numpy(b).to(dev)


def check_edt(shape, dev, kind="random") -> dict:
    """K2 against its plain version on one volume (``edt_mask``): the full
    per-slice EDT must be equal exactly; the two passes are timed on both.
    Returns a row."""
    from hcunet_tpu_torch.ops.distance import _axis_pass_plain, _dist2, edt, edt_axis_pass, edt_plain

    b = edt_mask(shape, kind, dev)
    got = edt(b, axes=(0, 1))
    want = edt_plain(b, axes=(0, 1))
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"K2 differs from its plain version at {shape} ({kind}): {err}")
    del got, want

    d2 = _dist2(b).contiguous()
    kernel_ms = cuda_ms(lambda: edt_axis_pass(edt_axis_pass(d2, 0), 1))
    plain_ms = cuda_ms(lambda: _axis_pass_plain(_axis_pass_plain(d2, 0), 1), reps=1)
    # each pass reads and writes the float32 volume once
    t_bytes = 2 * 2 * d2.numel() * 4 / H100_BYTES_PER_S * 1e3
    # the envelope's own bound: per element and pass at least one boundary
    # test (~8 FP64 operations) and one output (2 float32 operations); and
    # each row's chain of dependent steps, n to build and n to sweep
    t_ops = 2 * d2.numel() * (8 / H100_F64_FLOPS + 2 / H100_F32_FLOPS) * 1e3
    chain = 2 * shape[0] + 2 * shape[1]
    name = "edt_pass[" + "x".join(map(str, shape)) + ",axes01" + ("" if kind == "random" else f",{kind}") + "]"
    print(
        f"  {name:40s} exact; kernel {kernel_ms:8.3f} ms plain {plain_ms:9.3f} ms "
        f"bound {t_bytes:6.3f} ms (bytes); envelope ops {t_ops:6.3f} ms, chain {chain} "
        f"steps a row, {kernel_ms * 1e6 / chain:.1f} ns a step",
        flush=True,
    )
    return {
        "name": name,
        "route": "cuda",
        "source": "hcunet_tpu_torch/csrc/edt_pass.cu",
        "replaces": "scripts/probe_edt_device.py:67",
        "launches": None,
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": t_bytes,
        "bound_by": "bytes",
        "library_ms": None,
    }


def build_detector(dev):
    """Full-width ResNet50-FPN ``Detector`` with random weights from the
    seed: LeCun-normal kernels, the RPN head and box predictor small as in
    torchvision's init (so that boxes stay boxes), and random batch-norm
    scales, biases and statistics (the zero-init last BN of each bottleneck
    would hide its residual branch)."""
    from hcunet_tpu_torch.config import DetectorConfig
    from hcunet_tpu_torch.models.detection import Detector

    det = Detector(DetectorConfig(), backbone="resnet50", device=dev)
    gen = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        for name, m in det.named_modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                std = 1.0 / math.sqrt(m.weight[0].numel())
                if name.startswith("rpn.head"):
                    std = 0.01
                elif name.endswith("cls_score"):
                    std = 0.1
                elif name.endswith("box_predictor.bbox_pred"):
                    std = 0.001
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * std)
                if m.bias is not None:
                    m.bias.copy_(torch.randn(m.bias.shape, generator=gen) * 0.1)
            elif isinstance(m, torch.nn.BatchNorm2d):
                m.weight.copy_(torch.rand(m.weight.shape, generator=gen) + 0.5)
                m.bias.copy_(torch.randn(m.bias.shape, generator=gen) * 0.1)
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=gen) + 0.5)
    return det


def check_detector(det, images) -> None:
    """The detector on the card against the same weights on the CPU, on a
    small batch: the same number of valid rows per image, and each valid
    row matched by one of the other side's with the same label, its box
    within 1e-2 px and its score within 1e-4 (cuDNN's and the CPU's float32
    convs sum in other orders through ~60 layers, so rows whose scores
    nearly tie may come out in another order)."""
    from hcunet_tpu_torch.models.detection import Detector

    cpu = Detector(det.config, backbone="resnet50", device="cpu")
    cpu.load_state_dict(det.state_dict())
    got = {k: v.cpu().numpy() for k, v in det.detect(images).items()}
    want = {k: v.numpy() for k, v in cpu.detect(images).items()}
    worst_box, worst_score, n_valid = 0.0, 0.0, 0
    for b in range(images.shape[0]):
        g, w = got["valid"][b], want["valid"][b]
        if g.sum() != w.sum():
            raise AssertionError(f"image {b}: {g.sum()} valid rows on the card, {w.sum()} on the CPU")
        n_valid += int(w.sum())
        gb, wb = got["boxes"][b][g], want["boxes"][b][w]
        # [card row, cpu row] box distance; another label never matches
        dist = np.abs(gb[:, None, :] - wb[None, :, :]).max(-1)
        dist[got["labels"][b][g][:, None] != want["labels"][b][w][None, :]] = np.inf
        match = dist.argmin(1)
        if len(set(match.tolist())) != len(match):
            raise AssertionError(f"image {b}: the card's rows do not match the CPU's one to one")
        worst_box = max(worst_box, float(dist.min(1).max(initial=0)))
        d_score = np.abs(got["scores"][b][g] - want["scores"][b][w][match])
        worst_score = max(worst_score, float(d_score.max(initial=0)))
    print(
        f"detector on the card vs the CPU on {images.shape}: {n_valid} valid rows matched; "
        f"max |d box| {worst_box:.3e} px, max |d score| {worst_score:.3e}",
        flush=True,
    )
    if n_valid == 0 or worst_box > 1e-2 or worst_score > 1e-4:
        raise AssertionError("the detector on the card disagrees with the CPU")


def n_instance_tiles(spatial) -> int:
    """Instance tiles over an [X, Y] plane at ``INSTANCE_HOST_RAM``'s
    geometry; K2 launches twice (axes 0 and 1) on each."""
    from hcunet_tpu_torch.core.shapes import calculate_indexes
    from hcunet_tpu_torch.infer.instance import _instance_tile_geometry

    pad, ev = _instance_tile_geometry(spatial, INSTANCE_HOST_RAM)
    return math.prod(
        1 if e >= s else len(calculate_indexes(p, e, s, s))
        for p, e, s in zip(pad, ev, spatial)
    )


def slice2_path(model, vol, dev, kernels):
    """Slice 2's path on one volume, with every launch count set to 0 just
    before it: semantic mask, detection, instance watershed.  Returns the
    instance stage's arguments (for the profile) and the counts."""
    from hcunet_tpu_torch.config import WatershedConfig
    from hcunet_tpu_torch.infer.detect import (
        collect_cell_candidates,
        dispatch_cell_candidates,
        predict_cell_candidates,
    )
    from hcunet_tpu_torch.infer.instance import generate_unique_segmentation_mask
    from hcunet_tpu_torch.infer.serving import Segmenter

    seg = Segmenter(model, use_probability_map=False, dtype=torch.bfloat16, device=dev)
    det = build_detector(dev)
    ws = WatershedConfig(backend="device")
    # the pipeline's normalize (pipeline.py:394-404): (v - 0.5) / 0.5
    norm = (vol - np.float32(0.5)) / np.float32(0.5)
    seg.warmup([vol.shape[:-1]])
    check_detector(det, np.ascontiguousarray(np.moveaxis(norm[:256, :256, :2, :3], 2, 0)))
    predict_cell_candidates(norm[:1047, :1047, :2][..., [0, 2, 3]], det, device=dev)  # warm

    sec = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels.values())
    t0 = time.perf_counter()
    mask = seg.predict(norm)
    sec["segment"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pending = dispatch_cell_candidates(norm[..., [0, 2, 3]], det, device=dev)
    torch.cuda.synchronize()
    sec["detect"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cand = collect_cell_candidates(pending)
    sec["merge"] = time.perf_counter() - t0
    n_det_tiles = len(pending)
    del pending
    t0 = time.perf_counter()
    labels, seeds = generate_unique_segmentation_mask(
        mask, cand, ws, host_ram_bytes=INSTANCE_HOST_RAM, device=dev
    )
    sec["instance"] = time.perf_counter() - t0
    counts = {name: k.launches for name, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated()

    check_k1_routes(kernels["K1"].route_launches, n_tile_batches(seg, vol.shape[:-1]), torch.bfloat16)
    want_k1 = 15 * n_tile_batches(seg, vol.shape[:-1])
    want_k2 = 2 * n_instance_tiles(vol.shape[:2])
    if counts["K1"] != want_k1 or counts["K2"] != want_k2:
        raise AssertionError(
            f"slice 2 path launched K1 {counts['K1']} (expected {want_k1}) and "
            f"K2 {counts['K2']} (expected {want_k2}) times"
        )
    if mask.dtype != np.uint8 or mask.shape != vol.shape[:-1]:
        raise AssertionError(f"bad semantic mask {mask.dtype} {mask.shape}")
    if len(cand["scores"]) == 0 or not np.isfinite(cand["boxes"]).all():
        raise AssertionError("the detector gave no finite candidates")
    if labels.shape != mask.shape or seeds.shape != mask.shape:
        raise AssertionError(f"bad instance volumes {labels.shape} {seeds.shape}")
    n_inst = len(np.unique(labels)) - 1
    print(
        f"slice 2 path on {vol.shape}: segment {sec['segment']:.3f} s (foreground "
        f"{mask.mean():.3f}), detect {sec['detect']:.3f} s ({n_det_tiles} tiles dispatched and "
        f"finished on the card), merge {sec['merge']:.3f} s (host NMS, "
        f"{len(cand['scores'])} candidates), instance {sec['instance']:.3f} s "
        f"({n_inst} instances, "
        f"{len(np.unique(seeds)) - 1} seeds); total {sum(sec.values()):.3f} s; "
        f"launches K1 {counts['K1']} = 15 x {counts['K1'] // 15} tile batches, K2 "
        f"{counts['K2']} = 2 x {counts['K2'] // 2} instance tiles; peak device "
        f"memory {peak / 2**30:.2f} GiB",
        flush=True,
    )
    tile = np.ascontiguousarray(np.moveaxis(norm[:1047, :1047, :, [0, 2, 3]], 2, 0))
    profile_device(f"detection of one tile {tile.shape}", lambda: det.detect(tile), {})
    return (mask, cand, ws), counts


def blob_scene(rng, shape, spacing=44):
    """The instance scene of ``tests/test_watershed_parity.py::_instance_scene``
    at full tile size, its blobs on a jittered grid (so that no two seeds
    overlap), and a box on each blob."""
    X, Y, Z = shape
    xx, yy = np.meshgrid(np.arange(X), np.arange(Y), indexing="ij")
    zz = np.arange(Z)
    prob = np.zeros(shape, np.float32)
    boxes = []
    for cx in range(spacing, X - spacing, spacing):
        for cy in range(spacing, Y - spacing, spacing):
            x0, y0 = cx + rng.uniform(-6, 6), cy + rng.uniform(-6, 6)
            sl = np.s_[int(x0) - 20 : int(x0) + 20, int(y0) - 20 : int(y0) + 20]
            d2 = ((xx[sl] - x0) ** 2 + (yy[sl] - y0) ** 2)[..., None] / 60 + (
                zz - Z / 2
            ) ** 2 / 8
            prob[sl] = np.maximum(prob[sl], np.exp(-d2)).astype(np.float32)
            boxes.append([x0 - 8, y0 - 8, x0 + 8, y0 + 8])
    prob = np.where(prob < 0.25, 0.0, prob) * 10.0
    n = len(boxes)
    cand = {
        "boxes": np.asarray(boxes, np.float32),
        "scores": np.full(n, 0.9, np.float32),
        "labels": np.ones(n, np.int32),
        "z_level": np.full(n, float(Z // 2), np.float32),
    }
    return (prob > 2.5).astype(np.uint8), cand


def check_instance_stage(dev):
    """The instance stage on one full tile of blobs: labels with K2 must
    equal labels with the plain EDT, and >= 90 % of the seeded blobs must
    come back as labels."""
    from hcunet_tpu_torch.config import WatershedConfig
    from hcunet_tpu_torch.infer.instance import generate_unique_segmentation_mask
    from hcunet_tpu_torch.ops.distance import edt_plain

    mask, cand = blob_scene(np.random.default_rng(SEED), INSTANCE_TILE)
    ws = WatershedConfig(backend="device")
    kw = dict(host_ram_bytes=INSTANCE_HOST_RAM, device=dev)
    t0 = time.perf_counter()
    labels, seeds = generate_unique_segmentation_mask(mask, cand, ws, **kw)
    sec = time.perf_counter() - t0
    labels_p, seeds_p = generate_unique_segmentation_mask(mask, cand, ws, edt_fn=edt_plain, **kw)
    if not (np.array_equal(labels, labels_p) and np.array_equal(seeds, seeds_p)):
        raise AssertionError(
            f"instance labels with K2 differ from the plain EDT's at "
            f"{int((labels != labels_p).sum())} voxels"
        )
    seeded = set(np.unique(seeds)) - {0}
    found = seeded & set(np.unique(labels))
    share = len(found) / max(1, len(seeded))
    print(
        f"instance stage on blob scene {INSTANCE_TILE}: labels with K2 == labels "
        f"with the plain EDT; {len(found)} of {len(seeded)} seeded blobs found "
        f"({100 * share:.1f}%, need >= 90%); {sec:.3f} s",
        flush=True,
    )
    if share < 0.9:
        raise AssertionError(f"only {len(found)} of {len(seeded)} seeded blobs found")

def dot_inputs(x_shape, n, dtype, dev):
    """K3's inputs from the seed: a random ``x [*x_shape]`` and ``w [K, n]``
    scaled by 1/sqrt(K)."""
    K = x_shape[-1]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn(x_shape, generator=gen, device=dev, dtype=dtype)
    w = (torch.randn((K, n), generator=gen, device=dev) / math.sqrt(K)).to(dtype)
    return x, w


def check_dot(name, x_shape, n, dtype, dev, pieces, route) -> dict:
    """K3 against its plain version on ``x [*x_shape] @ w [K, n]``; returns a
    row.  ``pieces``: row counts of the A slices that make up the whole
    product (None: one launch over ``x``); each slice is one launch over the
    same A (``x_shape`` holds one slice), and the times are those of the
    whole product.  ``route``: the path K3 must take."""
    from hcunet_tpu_torch.ops.dot import DOT_BLOCKED, dot_blocked, dot_blocked_plain, dot_blocked_route

    K = x_shape[-1]
    x, w = dot_inputs(x_shape, n, dtype, dev)
    if dot_blocked_route(dtype, K, n) != route:
        raise AssertionError(f"{name}: K3's rule names the {dot_blocked_route(dtype, K, n)} "
                             f"path, expected {route}")
    before = dict(DOT_BLOCKED.route_launches)
    got = dot_blocked(x, w)
    taken = [r for r, c in DOT_BLOCKED.route_launches.items() if c != before[r]]
    if taken != [route]:
        raise AssertionError(f"{name}: K3 took the path(s) {taken}, expected {route}")
    want = dot_blocked_plain(x, w)
    torch.cuda.synchronize()
    err, tol = kernel_error(got, want)
    del got, want
    if pieces is None:
        parts = [x]
    else:
        parts = [x[:, :, :p] for p in pieces]

    def whole(fn):
        return lambda: [fn(p, w) for p in parts]

    kernel_ms = cuda_ms(whole(dot_blocked))
    plain_ms = cuda_ms(whole(dot_blocked_plain))
    library_ms = cuda_ms(whole(torch.matmul))
    M = sum(p.numel() // K for p in parts)
    es = x.element_size()
    flops = 2.0 * M * K * n
    nbytes = (M * K + K * n + M * n) * es
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    dt = "bf16" if dtype == torch.bfloat16 else "f32"
    row = {
        "name": f"dot_blocked[{name},{dt}]",
        "route": "cuda",
        "k3_route": route,
        "source": "hcunet_tpu_torch/csrc/dot_blocked.cu",
        "replaces": "scripts/probe_pallas_dot.py:35",
        "launches": None,
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
    }
    print(
        f"  {row['name']:34s} {route:5s} (M,K,N)=({M},{K},{n}) in {len(parts)} launch(es) err "
        f"{err:.3e} (tol {tol:.3e}) kernel {kernel_ms:8.3f} ms plain {plain_ms:8.3f} ms "
        f"matmul {library_ms:8.3f} ms bound {row['bound_ms']:7.3f} ms ({row['bound_by']}, "
        f"{flops / kernel_ms / 1e9:.1f} TFLOP/s, {nbytes / kernel_ms / 1e6:.0f} GB/s)",
        flush=True,
    )
    if not err <= tol:
        raise AssertionError(f"{row['name']}: max error {err} > tolerance {tol}")
    return row


def dot_cases(gemms, dtype) -> list:
    """K3's cases in ``dtype``: ``(name, x_shape, n, pieces, route)`` for the
    TPU probe's shapes and each layer GEMM (M, K, N) of ``gemms``, whose A
    is cut into slices of at most ``DOT_SLICE_ELEMS`` (``pieces``: their row
    counts).  ``route``: the path K3 must take, the ring at both probe
    cases and at every bf16 layer GEMM but out_conv's (N = 1), the basic
    path for out_conv and every float32 case."""
    ring = "ring" if dtype == torch.bfloat16 else "basic"
    cases = [(name, x_shape, n, None, ring) for name, x_shape, n in DOT_PROBE_CASES]
    for name, (M, K, N) in zip(LAYER_NAMES, gemms):
        per = max(1, min(M, DOT_SLICE_ELEMS // K))
        pieces = [per] * (M // per) + ([M % per] if M % per else [])
        cases.append((name, (1, 1, per, K), N, pieces, "basic" if name == "out_conv" else ring))
    return cases


def dot_sums(rows, dt, other=None) -> None:
    """K3 over the 15 layer GEMMs in ``dt`` beside cuBLAS, the bound and,
    where given, the rows' ``other`` key."""
    sel = [r for r in rows if r["name"] in {f"dot_blocked[{n},{dt}]" for n in LAYER_NAMES}]
    ms, lib, bound = (sum(r[k] for r in sel) for k in ("ms", "library_ms", "bound_ms"))
    extra = f", {other} {sum(r[other] for r in sel):.3f} ms" if other else ""
    print(f"K3 {dt}, 15 layer GEMMs: kernel {ms:.3f} ms, cuBLAS {lib:.3f} ms (kernel/cuBLAS "
          f"{ms / lib:.3f}), bound {bound:.3f} ms (kernel at {100 * bound / ms:.1f}% of it){extra}",
          flush=True)


def dot_phase(gemms, k1_rows, dev) -> list:
    """K3 at the TPU probe's shapes and at each K1 layer's GEMM shape, in
    bfloat16 and float32, each on the path it must take (``dot_cases``).
    Prints the sums over the 15 layer GEMMs beside cuBLAS and the bound, and
    K3's time over K1's per layer."""
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        print(f"K3 vs plain, {dtype}:")
        for name, x_shape, n, pieces, route in dot_cases(gemms, dtype):
            rows.append(check_dot(name, x_shape, n, dtype, dev, pieces, route))
            torch.cuda.empty_cache()
    for dt in ("bf16", "f32"):
        dot_sums(rows, dt)
    if not k1_rows:
        return rows
    k1 = {r["name"]: r["ms"] for r in k1_rows}
    for dt in ("bf16", "f32"):
        print(f"K3 / K1 per layer, {dt} (K3: the product alone, on a dense A; K1: the conv):")
        tot1 = tot3 = 0.0
        for row in rows:
            m = re.fullmatch(rf"dot_blocked\[(.+),{dt}\]", row["name"])
            if not m or m.group(1) not in LAYER_NAMES:
                continue
            t1 = k1[f"conv3d_valid[{m.group(1)},{dt}]"]
            tot1, tot3 = tot1 + t1, tot3 + row["ms"]
            print(f"  {m.group(1):12s} K1 {t1:8.3f} ms  K3 {row['ms']:8.3f} ms  K3/K1 {row['ms'] / t1:.3f}")
        print(f"  15 layers    K1 {tot1:8.3f} ms  K3 {tot3:8.3f} ms  K3/K1 {tot3 / tot1:.3f}")
    return rows


def pipeline_scene(X, Y, Z, n_cells, seed=0):
    """The JAX bench's pipeline scene (``hcunet_tpu/benchmarks.py:315
    _blob_scene``): a 4-channel uint16 volume of gaussian-blob cells, and its
    truth map."""
    rng = np.random.default_rng(seed)
    prob = np.zeros((X, Y, Z), np.float32)
    r = 18
    zz = (np.arange(Z) - Z // 2).astype(np.float32) ** 2 / 12.0
    for _ in range(n_cells):
        x0 = int(rng.uniform(r, X - r))
        y0 = int(rng.uniform(r, Y - r))
        xs, ys = slice(x0 - r, x0 + r), slice(y0 - r, y0 + r)
        gx = (np.arange(x0 - r, x0 + r) - x0).astype(np.float32) ** 2
        gy = (np.arange(y0 - r, y0 + r) - y0).astype(np.float32) ** 2
        g = np.exp(-(gx[:, None, None] + gy[None, :, None]) / 90.0 - zz[None, None, :])
        prob[xs, ys] = np.maximum(prob[xs, ys], g)
    vol = np.stack([prob * s for s in (0.9, 1.0, 0.95, 0.9)], axis=-1) + rng.normal(
        0, 0.01, (X, Y, Z, 4)
    ).astype(np.float32)
    return (vol.clip(0, 1) * 65535.0 + 0.5).astype(np.uint16), prob


def unet_tile_batches(spatial, tile_cfg) -> int:
    """Tile batches ``predict_segmentation_mask`` runs over one volume."""
    ev = [min(e, s) for e, s in zip(tile_cfg.eval_size, spatial)]
    tiles = math.prod(-(-s // e) for s, e in zip(spatial, ev))
    return -(-tiles // tile_cfg.batch)


class ChunkLog(logging.Handler):
    """Collects the pipeline's per-chunk candidate and cell counts."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def emit(self, record):
        m = re.match(r"(chunk_\d+_\d+)(?: done)?: (\d+) (candidates|cells)", record.getMessage())
        if m:
            self.counts.setdefault(m.group(1), {})[m.group(3)] = int(m.group(2))


def analyze_phase(model, dev, kernels) -> dict:
    """Slice 3's path: ``analyze`` on the JAX bench's pipeline scene.
    Returns the timed run's launch counts."""
    from hcunet_tpu_torch import PipelineConfig, analyze, auto_tile_config
    from hcunet_tpu_torch.config import device_hbm_bytes
    from hcunet_tpu_torch.infer.compile import compile_serving_apply
    from hcunet_tpu_torch.infer.detect import predict_cell_candidates
    from hcunet_tpu_torch.infer.instance import generate_unique_segmentation_mask
    from hcunet_tpu_torch.infer.tiling import predict_segmentation_mask

    ucfg = model.config
    apply = compile_serving_apply(model, dtype=torch.bfloat16, device=dev)
    det = build_detector(dev)
    cfg = PipelineConfig(
        numchunks=3, unet=ucfg, tiles=auto_tile_config(ucfg, hbm_bytes=device_hbm_bytes(dev)),
        prob_transfer_dtype="uint16",
    )
    vol, _truth = pipeline_scene(*PIPELINE_SCENE, PIPELINE_CELLS, seed=SEED)
    mvx = math.prod(PIPELINE_SCENE) / 1e6
    edges = np.linspace(0, PIPELINE_SCENE[0], cfg.numchunks).astype(int)
    chunk = (int(edges[1] - edges[0]), int(edges[1] - edges[0]), PIPELINE_SCENE[2])
    want_k1 = 15 * unet_tile_batches(chunk, cfg.tiles) * (cfg.numchunks - 1) ** 2
    log = ChunkLog()
    logging.getLogger("hcunet_tpu_torch.infer.pipeline").addHandler(log)
    root = tempfile.mkdtemp(prefix="chip_smoke_analyze_")
    # bit-reproducible device runs, so that the transfer check can hold the
    # uint16 and float32 runs to each other
    torch.backends.cudnn.deterministic = True

    def run(c, work, volume=vol, detector=det, **kw):
        return analyze(volume=volume, unet_apply=apply, detector=detector, cfg=c,
                       work_dir=os.path.join(root, work), fit_cochlea=False, device=dev, **kw)

    try:
        print(f"slice 3 path: analyze on {vol.shape} {vol.dtype}, {cfg.tiles}, "
              f"{(cfg.numchunks - 1) ** 2} chunks of {chunk}", flush=True)
        # the warm run: the device stages on one chunk of the timed run's
        # shape, so that every shape it meets is built and cached: analyze
        # on the chunk alone (numchunks=2 cuts none) without the detector,
        # which leaves the flood nothing to do, then the detector on it
        x = torch.from_numpy(vol[: chunk[0], : chunk[1]].astype(np.float32)).to(dev)
        x = ((x / 65536.0 - 0.5) / 0.5)[None]  # the pipeline's normalize
        t0 = time.perf_counter()
        run(dataclasses.replace(cfg, numchunks=2), "warm", vol[: chunk[0], : chunk[1]], None)
        predict_cell_candidates(x[0][..., list(cfg.detection_channels)], det, device=dev)
        warm_s = time.perf_counter() - t0
        log.counts.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(kernels.values())
        t0 = time.perf_counter()
        res = run(cfg, "timed")
        wall = time.perf_counter() - t0
        counts = {name: k.launches for name, k in kernels.items()}
        peak = torch.cuda.max_memory_allocated()
        print(
            f"analyze (uint16 transfer, overlap on): wall {wall:.3f} s, {mvx / wall:.3f} MVx/s "
            f"({mvx:.1f} MVx; warm-up on one chunk {warm_s:.3f} s); stage seconds "
            f"{ {k: round(v, 3) for k, v in res.stage_seconds.items()} }; stage bytes "
            f"{res.stage_bytes}; peak device memory {peak / 2**30:.2f} GiB; launches {counts} "
            f"(K1 15 x {counts['K1'] // 15} tile batches); cells {len(res.cells)}; per chunk "
            f"{dict(sorted(log.counts.items()))}",
            flush=True,
        )
        if counts["K1"] != want_k1:
            raise AssertionError(f"analyze launched K1 {counts['K1']} times, expected {want_k1}")
        check_k1_routes(kernels["K1"].route_launches, want_k1 // 15, torch.bfloat16)
        if res.mask.shape != vol.shape[:-1] or not np.isfinite(res.mask).all():
            raise AssertionError(f"bad mask {res.mask.shape}")
        if res.unique_mask.shape != vol.shape[:-1] or res.unique_mask.dtype != np.int32:
            raise AssertionError(f"bad instances {res.unique_mask.dtype} {res.unique_mask.shape}")

        # resume from the timed run's journal: every chunk cached
        reset_counts(kernels.values())
        t0 = time.perf_counter()
        again = run(cfg, "timed")
        resume_s = time.perf_counter() - t0
        k1_again = kernels["K1"].launches
        same = [(c.unique_id, c.center, c.volume) for c in again.cells] == [
            (c.unique_id, c.center, c.volume) for c in res.cells
        ]
        print(f"resume from the journal: {resume_s:.3f} s, K1 launches {k1_again}, "
              f"same {len(again.cells)} cells: {same}", flush=True)
        if k1_again != 0 or not same or not np.array_equal(again.unique_mask, res.unique_mask):
            raise AssertionError("resume recomputed a chunk or returned other cells")
        del again

        # is the device path bit-reproducible?  The U-Net on one chunk, twice
        post = (cfg.gaussian_sigma, cfg.prob_floor, cfg.prob_scale)
        p1, p2 = (predict_segmentation_mask(apply, x, ucfg, cfg.tiles, use_probability_map=True,
                                            postprocess=post, device=dev) for _ in range(2))
        reproducible = bool(torch.equal(p1, p2))
        del p1, p2

        # the float32 transfer, sequential, under the profiler
        cfg32 = dataclasses.replace(cfg, prob_transfer_dtype="float32")
        t0 = time.perf_counter()
        res32 = profile_device(
            "analyze (float32 transfer, overlap off)",
            lambda: run(cfg32, "f32", overlap=False), {"K1": "conv3d_valid"},
        )
        print(f"analyze (float32 transfer, overlap off) under the profiler: "
              f"{time.perf_counter() - t0:.3f} s; stage seconds "
              f"{ {k: round(v, 3) for k, v in res32.stage_seconds.items()} }; stage bytes "
              f"{res32.stage_bytes}", flush=True)
        tol = cfg.prob_scale / 131070 + 1e-6
        a, b = res.mask, res32.mask
        bad = np.abs(a - b) > tol
        floor = cfg.prob_floor * cfg.prob_scale
        near = bad & (np.minimum(a, b) == 0) & (np.abs(np.maximum(a, b) - floor) <= 1e-4)
        n_bad, n_near = int(bad.sum()), int(near.sum())
        print(f"uint16 vs float32 transfer: max |d mask| {float(np.abs(a - b).max()):.3e} "
              f"(tolerance {tol:.3e}); {n_bad} voxels over, {n_near} of them within 1e-4 of the "
              f"floor {floor}; device path bit-reproducible: {reproducible}; cells "
              f"{len(res.cells)} vs {len(res32.cells)}", flush=True)
        if n_bad > n_near or (n_near and reproducible):
            raise AssertionError("the uint16 transfer's mask differs from the float32 run's")

        # "fused" == "materialized" on one chunk's map; the two floods run
        # at once (each releases the GIL)
        prob = np.ascontiguousarray(res32.mask[: chunk[0], : chunk[1]])
        cand = predict_cell_candidates(x[0][..., list(cfg.detection_channels)], det, device=dev)

        def flood(backend):
            t = time.perf_counter()
            out = generate_unique_segmentation_mask(
                prob, cand, dataclasses.replace(cfg.watershed, backend=backend), device=dev
            )[0]
            return out, time.perf_counter() - t

        with ThreadPoolExecutor(max_workers=2) as pool:
            (fused, fused_s), (mat, mat_s) = pool.map(flood, ("fused", "materialized"))
        equal = np.array_equal(fused, mat)
        print(f"chunk_1_1 {prob.shape}, {len(cand['scores'])} candidates: fused {fused_s:.3f} s, "
              f"materialized {mat_s:.3f} s (at once), {len(np.unique(fused)) - 1} labels, "
              f"equal: {equal}", flush=True)
        if not equal:
            raise AssertionError("the fused and materialized backends disagree")
        return counts
    finally:
        torch.backends.cudnn.deterministic = False
        logging.getLogger("hcunet_tpu_torch.infer.pipeline").removeHandler(log)
        shutil.rmtree(root, ignore_errors=True)


def gemm_shape(x_shape, w) -> tuple:
    """A layer's GEMM (M, K, N): output voxels, taps x Cin, Cout."""
    out_vox = x_shape[0] * math.prod(s - k + 1 for s, k in zip(x_shape[1:4], w.shape[:3]))
    return out_vox, math.prod(w.shape[:4]), w.shape[4]


def k1_phase(layers, gen, dev) -> list:
    """Phase 3: K1 against its plain version at the 15 layer shapes of the
    serving forward and the TPU probe's case 1, in bfloat16 and float32."""
    xs, ws = PROBE_CASE_1
    probe_w = torch.randn(ws, generator=gen) / math.sqrt(math.prod(ws[:4]))
    probe_b = torch.randn(ws[-1], generator=gen) * 0.1
    cases = [
        (name, x_shape, w, b, relu)
        for name, (x_shape, w, b, relu) in zip(LAYER_NAMES, layers)
    ] + [("probe_case_1", xs, probe_w.to(dev), probe_b.to(dev), True)]
    gen_dev = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        print(f"K1 vs plain, {dtype}:")
        for name, x_shape, w, b, relu in cases:
            x = torch.randn(x_shape, generator=gen_dev, device=dev).to(dtype)
            rows.append(check_kernel(name, x, w.to(dtype).contiguous(), b, relu))
            del x
            torch.cuda.empty_cache()
    k1_sums(rows)
    return rows


def slice1_phase(model, seg, dev, kernel) -> int:
    """Phase 5: three bf16 requests and a float32 one through K1, the
    float32 one against a forward on the plain conv.  Returns K1's
    launches."""
    from hcunet_tpu_torch.infer.compile import compile_serving_apply
    from hcunet_tpu_torch.infer.serving import Segmenter
    from hcunet_tpu_torch.infer.tiling import predict_segmentation_mask
    from hcunet_tpu_torch.ops.conv import conv3d_valid_plain

    cfg, tile_cfg = model.config, seg.tile_cfg
    rng = np.random.default_rng(SEED)
    vols = [rng.random((*sp, cfg.in_channels), dtype=np.float32) for sp in REQUESTS]
    seg.warmup([REQUESTS[0]])
    total = 0
    for sp, vol in zip(REQUESTS, vols):
        out, sec, n, peak = run_request(seg, vol, kernel)
        total += n
        print(
            f"request {sp}: {sec:.3f} s, {math.prod(sp) / sec / 1e6:.2f} MVx/s, "
            f"{n} K1 launches = 15 x {n // 15} tile batches ({kernel.route_launches}), "
            f"peak device memory {peak / 2**30:.2f} GiB, p in [{out.min():.4f}, {out.max():.4f}]",
            flush=True,
        )
        if sp == REQUESTS[0]:
            p_bf16 = out

    seg32 = Segmenter(model, dtype=torch.float32, device=dev, tile_cfg=tile_cfg)
    p_k, sec, n, _ = run_request(seg32, vols[0], kernel)
    total += n
    plain_apply = compile_serving_apply(
        seg32.model, dtype=torch.float32, device=dev, conv=conv3d_valid_plain
    )
    p_p = predict_segmentation_mask(
        plain_apply, vols[0][None], cfg, tile_cfg, use_probability_map=True,
        device=dev,
    )[0, ..., 0].cpu().numpy()
    d32 = float(np.abs(p_k - p_p).max())
    print(
        f"float32 request {REQUESTS[0]}: K1 path vs plain path max |dp| {d32:.3e} "
        f"(tolerance 1e-4); K1 path {sec:.3f} s; bf16 vs float32 max |dp| "
        f"{float(np.abs(p_bf16 - p_k).max()):.3e}"
    )
    if not d32 <= 1e-4:
        raise AssertionError(f"float32 K1 path differs from plain path by {d32}")
    profile_device(
        f"request {REQUESTS[-1]}", lambda: seg.predict(vols[-1]),
        {"K1": "conv3d_valid"},
    )
    return total


def slice2_phase(model, dev, kernels) -> dict:
    """Phase 7: slice 2's path on the bench scene, then its instance stage
    once more under the profiler.  Returns the launch counts."""
    from hcunet_tpu_torch.infer.instance import generate_unique_segmentation_mask

    scene = np.random.default_rng(SEED).random((*BENCH_SCENE, model.config.in_channels), np.float32)
    (mask, cand, ws), counts = slice2_path(model, scene, dev, kernels)
    profile_device(
        "the instance stage",
        lambda: generate_unique_segmentation_mask(
            mask, cand, ws, host_ram_bytes=INSTANCE_HOST_RAM, device=dev
        ),
        {"K2": "edt_pass_kernel"},
    )
    return counts


def fit_batch():
    """The JAX bench's fit input: the 256^2 crop of the pipeline scene,
    normalized ``(v - 0.5) / 0.5`` after the integer unit scale, and the
    target ``truth > 0.3``."""
    vol, truth = pipeline_scene(*PIPELINE_SCENE, PIPELINE_CELLS, seed=SEED)
    volf = vol[:FIT_CROP, :FIT_CROP].astype(np.float32) / np.float32(65536.0)
    x = ((volf - np.float32(0.5)) / np.float32(0.5))[None]
    y = (truth[:FIT_CROP, :FIT_CROP] > 0.3)[None, ..., None].astype(np.float32)
    return x, y


def layer_weight_shapes(cfg) -> list:
    """(Cin, Cout) of the dense weight of each of the 15 valid convs, in
    ``LAYER_NAMES``' order."""
    feats = cfg.feature_sizes
    cins = (cfg.in_channels,) + tuple(feats[:-1])
    shapes = [s for cin, f in zip(cins, feats) for s in ((cin, f), (f, f))]
    shapes += [s for f in reversed(feats[:-1]) for s in ((2 * f, f), (f, f))]
    return shapes + [(feats[0], cfg.out_channels)]


# the relative size of the jitter of the reference runs: a few float32
# ulps, the order of the gap two summation orders of one conv open
JITTER = 2.0**-22


@contextlib.contextmanager
def plain_conv(jitter=None):
    """The U-Net's valid convs on the plain version, their gradient by plain
    autograd (cuDNN), for the parity runs: no K1 launch.  ``jitter``: a
    ``torch.Generator`` on the card; each conv's float32 sum is then
    multiplied by ``1 + JITTER u`` (u uniform in [-1, 1], per element)
    before the cast to the working dtype, as another summation order would
    move it."""
    import hcunet_tpu_torch.ops.conv as conv_mod

    kernel = conv_mod.conv3d_valid

    def plain(x, w, b=None, relu=False, dilation=1):
        if jitter is None:
            return conv_mod.conv3d_valid_plain(x, w, b, relu, dilation)
        y = conv_mod.conv3d_valid_plain(x.float(), w.float(), b, relu, dilation)
        u = torch.rand(y.shape, generator=jitter, device=y.device) * 2 - 1
        return (y * (1 + JITTER * u)).to(x.dtype)

    conv_mod.conv3d_valid = plain
    try:
        yield
    finally:
        conv_mod.conv3d_valid = kernel


@contextlib.contextmanager
def recording_input_grad(records):
    """Record ``(gy shape, w, dilation)`` of every input-gradient call while
    it runs as usual (through K1 on the card)."""
    import hcunet_tpu_torch.ops.conv as conv_mod

    kernel = conv_mod.conv3d_valid_input_grad

    def record(gy, w, dilation=1):
        records.append((tuple(gy.shape), w.detach().clone(), dilation))
        return kernel(gy, w, dilation)

    conv_mod.conv3d_valid_input_grad = record
    try:
        yield
    finally:
        conv_mod.conv3d_valid_input_grad = kernel


# jittered plain runs, each from its own seed, that set the parity limits
N_JITTER = 3
# the kernel run may part from the plain run by this many times the largest
# gap that the jittered plain runs open, plus a floor per dtype, for each
# kind of gap: the losses' (relative), the step-1 gradients' (per tensor,
# the norm of the difference over the norm), the share of a parameter
# tensor's elements more than 0.1 lr apart, and the running statistics'
# (relative to their scale), each the largest over the tensors
# (hcunet_tpu_torch/train/parity.py).  In float32 K1's summation order
# differs from cuDNN's by more than the jitter's few ulps (the kernel's gaps
# were 1.3-2.6x one jittered run's), so 4x; in bf16 the cast of each
# conv's output to bf16 sets both (the kernel's gaps 0.56-2.5x), so 2x.
# bf16 holds no share: one jittered run already puts ~31 % of a tensor's
# elements 0.1 lr apart after 3 steps, so no limit below 1 separates a
# kernel from rounding there.
JITTER_FACTOR = {torch.float32: 4.0, torch.bfloat16: 2.0}
GAP_FLOOR = {torch.float32: {"loss": 1e-6, "grad": 1e-5, "share": 1e-3, "stats": 1e-5},
             torch.bfloat16: {"loss": 1e-3, "grad": 1e-3, "stats": 1e-3}}


def run_gaps(run_a, run_b, start) -> dict:
    """``{kind: (largest gap, tensor)}`` between two runs of
    ``PARITY_STEPS`` steps from the variables ``start`` (``run_*``: the
    variables after the steps, the losses, the step-1 gradients, as JAX
    trees), by ``hcunet_tpu_torch.train.parity``'s rule, which raises where
    a parameter did not move, is not finite, or the two runs part by more
    than Adam's step bound."""
    from hcunet_tpu_torch.train.parity import gradient_gaps, trajectory_gaps

    var_a, losses_a, g_a = run_a
    var_b, losses_b, g_b = run_b
    out = {"loss": (max(abs(a - b) / abs(b) for a, b in zip(losses_a, losses_b)), None)}
    per = {("grad", p): v for p, v in gradient_gaps(g_a, g_b).items()}
    per.update(trajectory_gaps(var_a, var_b, start, FIT_LR, PARITY_STEPS))
    for (kind, path), v in per.items():
        if v >= out.get(kind, (-1.0, None))[0]:
            out[kind] = (v, "/".join(path))
    return out


def trajectory_gap(kernel, plain, jittered, start, dtype) -> str:
    """The kernel run against the plain run, held by the gaps that
    rounding-sized jitters of the plain run's convs open (``run_gaps`` of
    each jittered run against the plain one): for each kind of gap, the
    largest over the tensors within ``JITTER_FACTOR`` times the largest of
    the jittered runs' plus ``GAP_FLOOR``.

    Why relative to the jitter: at production width the step-1 gradients
    of the deep layers are sums of many terms that nearly cancel, so a
    rounding difference in any conv moves them by far more than the
    dtype's epsilon, and Adam divides each step by the root of the squared
    gradient's average, so a parameter whose gradient is near 0 can move a
    whole step of lr apart in two runs.  The tight gate on K1 is the input
    gradient's check at each layer (``check_input_grad``)."""
    got = run_gaps(kernel, plain, start)
    noise = [run_gaps(j, plain, start) for j in jittered]
    factor, floor = JITTER_FACTOR[dtype], GAP_FLOOR[dtype]
    parts, bad = [], []
    for kind in floor:
        g, where = got[kind]
        n = max(r[kind][0] for r in noise)
        allowed = factor * n + floor[kind]
        parts.append(f"{kind} gap at most {g:.2e}{f' ({where})' if where else ''}, jittered runs "
                     f"{', '.join(f'{r[kind][0]:.2e}' for r in noise)}, allowed {allowed:.2e}")
        if g > allowed:
            bad.append(kind)
    line = "; ".join(parts)
    if bad:
        raise AssertionError(f"{line}; parted: {bad}")
    return line


def check_input_grad(name, gy, w, dilation) -> dict:
    """K1's input gradient against its plain version on one output gradient
    ``gy`` (``w`` in its dtype); returns a row."""
    from hcunet_tpu_torch.ops.conv import (
        CONV3D_VALID_INPUT_GRAD,
        conv3d_valid_input_grad,
        conv3d_valid_input_grad_plain,
        conv3d_valid_route,
    )

    dtype = gy.dtype
    kx, ky, kz, cin, cout = w.shape
    k1_route = conv3d_valid_route(dtype, cout, cin)
    before = dict(CONV3D_VALID_INPUT_GRAD.route_launches)
    got = conv3d_valid_input_grad(gy, w, dilation)
    taken = [r for r, n in CONV3D_VALID_INPUT_GRAD.route_launches.items() if n != before[r]]
    if taken != [k1_route]:
        raise AssertionError(f"{name}: K1 took the path(s) {taken}, expected {k1_route}")
    want = conv3d_valid_input_grad_plain(gy, w, dilation)
    torch.cuda.synchronize()
    err, tol = kernel_error(got, want)
    in_size = (gy.shape[0], cin, *got.shape[1:4])
    del got, want

    gy_cf = gy.permute(0, 4, 1, 2, 3)
    w_cf = w.permute(4, 3, 0, 1, 2)
    kernel_ms = cuda_ms(lambda: conv3d_valid_input_grad(gy, w, dilation))
    plain_ms = cuda_ms(lambda: conv3d_valid_input_grad_plain(gy, w, dilation))
    library_ms = cuda_ms(lambda: torch.nn.grad.conv3d_input(in_size, w_cf, gy_cf, dilation=dilation))
    out_vox = gy.numel() // cout
    es = gy.element_size()
    flops = 2.0 * out_vox * kx * ky * kz * cin * cout
    nbytes = (gy.numel() + w.numel() + math.prod(in_size)) * es
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    dt = "bf16" if dtype == torch.bfloat16 else "f32"
    row = {
        "name": f"conv3d_valid_input_grad[{name},{dt}]",
        "route": "cuda",
        "k1_route": k1_route,
        "source": "hcunet_tpu_torch/csrc/conv3d_valid.cu",
        "replaces": "hcunet_tpu/ops/conv.py:90 (XLA's input gradient of lax.conv_general_dilated; no Pallas kernel)",
        "launches": None,
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
    }
    print(
        f"  {row['name']:44s} {k1_route:5s} gy{list(gy.shape)} w{list(w.shape)} err {err:.3e} "
        f"(tol {tol:.3e}) kernel {kernel_ms:8.3f} ms plain {plain_ms:8.3f} ms "
        f"cudnn dgrad {library_ms:8.3f} ms bound {row['bound_ms']:7.3f} ms "
        f"({row['bound_by']}, {flops / kernel_ms / 1e9:.1f} TFLOP/s)",
        flush=True,
    )
    if not err <= tol:
        raise AssertionError(f"{row['name']}: max error {err} > tolerance {tol}")
    return row


def make_trainer(model, dev):
    from hcunet_tpu_torch.train.trainer import TrainConfig, UNetTrainer

    return UNetTrainer(
        model, cfg=TrainConfig(learning_rate=FIT_LR, loss_method="pixel", log_every=0), device=dev
    )


def train_fit(dev, x, y):
    """The fit: 40 bf16 steps, each checked for 15 forward and 14
    input-gradient launches of K1 on their paths.  Returns the trainer,
    the launch counts of the whole fit and the input gradients recorded
    at its first step."""
    from hcunet_tpu_torch.config import UNetConfig
    from hcunet_tpu_torch.models.unet import init_unet
    from hcunet_tpu_torch.ops.conv import CONV3D_VALID, CONV3D_VALID_INPUT_GRAD

    cfg = UNetConfig.production_3d()
    model = init_unet(cfg, torch.Generator().manual_seed(SEED), dtype=torch.bfloat16)
    trainer = make_trainer(model, dev)
    xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    fwd_want = {"basic": 1, "ring": 14}   # the 4-channel first conv on the basic path
    grad_want = {"basic": 1, "ring": 13}  # out_conv's (Cin' = 1) on the basic path
    records, losses, secs = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts([CONV3D_VALID, CONV3D_VALID_INPUT_GRAD])
    for step in range(FIT_STEPS):
        fwd0 = dict(CONV3D_VALID.route_launches)
        grad0 = dict(CONV3D_VALID_INPUT_GRAD.route_launches)
        t0 = time.perf_counter()
        if step == 0:
            with recording_input_grad(records):
                losses.append(trainer.train_step(xt, yt, None))
        else:
            losses.append(trainer.train_step(xt, yt, None))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        fwd = {r: n - fwd0[r] for r, n in CONV3D_VALID.route_launches.items()}
        grad = {r: n - grad0[r] for r, n in CONV3D_VALID_INPUT_GRAD.route_launches.items()}
        if fwd != fwd_want or grad != grad_want:
            raise AssertionError(f"step {step}: K1 forward {fwd} (expected {fwd_want}), "
                                 f"input gradient {grad} (expected {grad_want})")
    counts = {"forward": CONV3D_VALID.launches, "input_grad": CONV3D_VALID_INPUT_GRAD.launches}
    peak = torch.cuda.max_memory_allocated()
    step_ms = float(np.median(secs[1:])) * 1e3
    print(
        f"fit (production_3d, bf16, input {list(x.shape)}, {FIT_STEPS} Adam({FIT_LR}) steps, "
        f"pixel BCE): loss {losses[0]:.6f} -> {losses[-1]:.6f}; {step_ms:.3f} ms a step (median of "
        f"steps 2-{FIT_STEPS}; step 1 {secs[0] * 1e3:.1f} ms); peak device memory {peak / 2**30:.2f} "
        f"GiB; K1 launches: forward {counts['forward']} ({CONV3D_VALID.route_launches}), input "
        f"gradient {counts['input_grad']} ({CONV3D_VALID_INPUT_GRAD.route_launches}); losses "
        f"{[round(v, 5) for v in losses]}",
        flush=True,
    )
    if counts != {"forward": 15 * FIT_STEPS, "input_grad": 14 * FIT_STEPS}:
        raise AssertionError(f"the fit launched K1 {counts}")
    if not losses[-1] < losses[0] or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"the fit's loss did not fall: {losses[0]} -> {losses[-1]}")
    return trainer, counts, records


def train_parity(dev, x, y, dtype) -> None:
    """3 steps with K1 against 3 with the plain conv from the same weights,
    held by ``trajectory_gap`` to the gaps of ``N_JITTER`` runs on the
    plain conv with their conv outputs jittered by a few ulps."""
    from hcunet_tpu_torch.config import UNetConfig
    from hcunet_tpu_torch.models.unet import UNet, init_unet
    from hcunet_tpu_torch.ops.conv import CONV3D_VALID, CONV3D_VALID_INPUT_GRAD
    from hcunet_tpu_torch.utils.port_jax import jax_variables_from_unet_state_dict

    cfg = UNetConfig.production_3d()
    sd0 = init_unet(cfg, torch.Generator().manual_seed(SEED + 1)).state_dict()
    start = jax_variables_from_unet_state_dict(sd0, cfg)
    xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    runs = {"kernel": contextlib.nullcontext(), "plain": plain_conv()}
    runs.update({f"jittered{i}": plain_conv(torch.Generator(device=dev).manual_seed(SEED + i))
                 for i in range(N_JITTER)})
    for label, ctx in runs.items():
        model = UNet(cfg, dtype=dtype)
        model.load_state_dict(sd0)
        trainer = make_trainer(model, dev)
        before = (CONV3D_VALID.launches, CONV3D_VALID_INPUT_GRAD.launches)
        with ctx:
            losses = [trainer.train_step(xt, yt, None)]
            grads = jax_variables_from_unet_state_dict(
                {n: p.grad for n, p in model.named_parameters()}, cfg)["params"]
            losses += [trainer.train_step(xt, yt, None) for _ in range(PARITY_STEPS - 1)]
        launched = (CONV3D_VALID.launches - before[0], CONV3D_VALID_INPUT_GRAD.launches - before[1])
        want = (15 * PARITY_STEPS, 14 * PARITY_STEPS) if label == "kernel" else (0, 0)
        if launched != want:
            raise AssertionError(f"{label} run launched K1 {launched}, expected {want}")
        runs[label] = (trainer.variables, losses, grads)
        del trainer, model
        torch.cuda.empty_cache()
    jittered = [runs[f"jittered{i}"] for i in range(N_JITTER)]
    line = trajectory_gap(runs["kernel"], runs["plain"], jittered, start, dtype)
    print(f"train parity, {dtype}, {PARITY_STEPS} steps, K1 vs the plain conv: losses "
          + " vs ".join(str([round(v, 6) for v in r[1]]) for r in runs.values())
          + f" ({', '.join(runs)}); {line}", flush=True)


def train_phase(dev) -> tuple:
    """Phase 9: the fit, the parity runs, K1's input gradient layer by
    layer and the checkpoint round trip.  Returns the fitted model (eval
    mode), the fit's K1 counts and the input-gradient rows."""
    from hcunet_tpu_torch.config import UNetConfig
    from hcunet_tpu_torch.infer.serving import Segmenter

    x, y = fit_batch()
    trainer, counts, records = train_fit(dev, x, y)
    for dtype in (torch.float32, torch.bfloat16):
        train_parity(dev, x, y, dtype)

    # K1's input gradient at the fit's 14 layers; autograd runs them from
    # out_conv back to down0.conv2 (down0.conv1's input needs none)
    names = list(reversed(LAYER_NAMES))[:14]
    shapes = list(reversed(layer_weight_shapes(UNetConfig.production_3d())))[:14]
    got_shapes = [(w.shape[3], w.shape[4]) for _s, w, _d in records]
    if got_shapes != shapes:
        raise AssertionError(f"recorded input gradients {got_shapes}, expected {shapes}")
    gen_dev = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        print(f"K1 input gradient vs plain, {dtype}:")
        for name, (gy_shape, w, dil) in zip(names, records):
            gy = torch.randn(gy_shape, generator=gen_dev, device=dev).to(dtype)
            rows.append(check_input_grad(name, gy, w.to(dtype).contiguous(), dil))
            del gy
            torch.cuda.empty_cache()
    for dt in ("bf16", "f32"):
        sel = [r for r in rows if r["name"].endswith(f",{dt}]")]
        ms, lib, bound, plain = (sum(r[k] for r in sel) for k in ("ms", "library_ms", "bound_ms", "plain_ms"))
        print(f"K1 input gradient {dt}, 14 layers: kernel {ms:.3f} ms, cuDNN dgrad {lib:.3f} ms "
              f"(kernel/cuDNN {ms / lib:.3f}), plain {plain:.3f} ms, bound {bound:.3f} ms "
              f"(kernel at {100 * bound / ms:.1f}% of it)", flush=True)

    # the fitted weights through the checkpoint format into a Segmenter
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    torch.backends.cudnn.deterministic = True
    try:
        path = os.path.join(root, "fit.hcunet")
        trainer.save(path)
        vol = np.random.default_rng(SEED).random((*REQUESTS[0], 4), dtype=np.float32)
        from_ckpt = Segmenter.from_checkpoint(path, dtype=torch.bfloat16, device=dev)
        direct = Segmenter(trainer.model, trainer.variables, dtype=torch.bfloat16, device=dev)
        a, b = from_ckpt.predict(vol), direct.predict(vol)
        equal = bool(np.array_equal(a, b))
        print(f"checkpoint round trip ({os.path.getsize(path)} bytes): Segmenter.from_checkpoint "
              f"predict on {REQUESTS[0]} equal to a Segmenter on trainer.variables: {equal}; "
              f"p in [{a.min():.4f}, {a.max():.4f}], mean {a.mean():.4f}", flush=True)
        if not equal:
            raise AssertionError("the checkpoint round trip changed the prediction")
    finally:
        torch.backends.cudnn.deterministic = False
        shutil.rmtree(root, ignore_errors=True)
    return trainer.model.eval(), counts, rows


# phases that --phases can pick, in the order they run, and the kernels
# each launches
PHASES = {
    "k1": ("K1",),
    "k3": ("K3",),
    "slice1": ("K1",),
    "k2": ("K2",),
    "slice2": ("K1", "K2"),
    "blobs": ("K2",),
    "train": ("K1",),
    "slice3": ("K1", "K2", "host"),
}


def parse_phases(argv) -> list:
    import argparse

    ap = argparse.ArgumentParser(description="On-card smoke run of the PyTorch port.")
    ap.add_argument(
        "--phases", default="all",
        help="comma-separated phases to run, of " + ", ".join(PHASES)
        + " (default: all). The card line and the builds always run; a subset reports"
        " no launch counts and ends with a partial line, not the result line.",
    )
    args = ap.parse_args(argv)
    if args.phases == "all":
        return list(PHASES)
    chosen = args.phases.split(",")
    unknown = set(chosen) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    return [p for p in PHASES if p in chosen]


def main(argv=None) -> int:
    phases = parse_phases(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not (Path(__file__).resolve().parent / "hcunet_tpu_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 1
    from hcunet_tpu_torch.config import UNetConfig
    from hcunet_tpu_torch.infer.serving import Segmenter
    from hcunet_tpu_torch.csrc import build_all
    from hcunet_tpu_torch.ops.conv import CONV3D_VALID
    from hcunet_tpu_torch.ops.distance import EDT_PASS
    from hcunet_tpu_torch.ops.dot import DOT_BLOCKED
    from hcunet_tpu_torch.ops.watershed import WATERSHED_HOST

    t_start = time.perf_counter()
    marks = [("start", t_start)]  # (phase, time it ended)
    dev = torch.device("cuda")
    # phase 1: the card
    card = card_line()
    print(f"card: {card}; torch.cuda.get_device_name: {torch.cuda.get_device_name(0)}; "
          f"phases: {', '.join(phases)}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(
        f"TF32: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}"
    )

    # phase 2: build the kernels the phases launch, one nvcc each, and the
    # host flood with g++, all together
    kernels = {"K1": CONV3D_VALID, "K2": EDT_PASS, "K3": DOT_BLOCKED}
    needed = {k for p in phases for k in PHASES[p]}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        host = pool.submit(WATERSHED_HOST.load) if "host" in needed else None
        build_all(k for name, k in kernels.items() if name in needed)
        if host is not None:
            host.result()
    built = [f"{name} {k.build_seconds:.1f} s" for name, k in kernels.items() if name in needed]
    if host is not None:
        built.append(f"host flood {WATERSHED_HOST.build_seconds:.1f} s")
    print(f"built by nvcc for sm_90a (the host flood by g++) in "
          f"{time.perf_counter() - t0:.1f} s: {', '.join(built)}", flush=True)
    marks.append(("builds", time.perf_counter()))

    cfg = UNetConfig.production_3d()
    gen = torch.Generator().manual_seed(SEED)
    model = build_model(cfg, gen)
    seg = Segmenter(model, dtype=torch.bfloat16, device=dev)
    print(f"tile geometry: {seg.tile_cfg}")
    rows, k2_rows, k3_rows = [], [], []
    total = 0
    counts = counts3 = dict.fromkeys(kernels, 0)

    layers = record_layers(seg.model, seg.tile_cfg, dev) if {"k1", "k3"} & set(phases) else []
    # phase 3: K1 against its plain version at the main path's shapes
    if "k1" in phases:
        rows = k1_phase(layers, gen, dev)
        marks.append(("K1 checks", time.perf_counter()))
    # phase 4: K3 against its plain version, and beside K1
    if "k3" in phases:
        k3_rows = dot_phase([gemm_shape(x_shape, w) for x_shape, w, _b, _r in layers], rows, dev)
        marks.append(("K3 checks", time.perf_counter()))
    del layers
    # phase 5: slice 1's path
    if "slice1" in phases:
        total = slice1_phase(model, seg, dev, CONV3D_VALID)
        marks.append(("slice 1", time.perf_counter()))
    del seg
    torch.cuda.empty_cache()
    # phase 6: K2 against its plain version at the main path's shapes
    if "k2" in phases:
        print("K2 vs plain (exact), axes (0, 1):")
        for shape, kind in [(shape, "random") for shape in EDT_SHAPES] + EDT_STRESS:
            k2_rows.append(check_edt(shape, dev, kind))
            torch.cuda.empty_cache()
        marks.append(("K2 checks", time.perf_counter()))
    # phase 7: slice 2's path on the bench scene
    if "slice2" in phases:
        counts = slice2_phase(model, dev, kernels)
        torch.cuda.empty_cache()
        marks.append(("slice 2", time.perf_counter()))
    # phase 8: the instance stage with K2 against the plain EDT
    if "blobs" in phases:
        check_instance_stage(dev)
        torch.cuda.empty_cache()
        marks.append(("instance blobs", time.perf_counter()))
    # phase 9: training, and the fitted weights for slice 3
    grad_rows = []
    train_counts = {"forward": 0, "input_grad": 0}
    if "train" in phases:
        model, train_counts, grad_rows = train_phase(dev)
        torch.cuda.empty_cache()
        marks.append(("train", time.perf_counter()))
    # phase 10: slice 3's path, analyze on the pipeline scene
    if "slice3" in phases:
        counts3 = analyze_phase(model, dev, kernels)
        marks.append(("slice 3", time.perf_counter()))

    # phase 11: results.  A kernel's launches are those of the whole main
    # path (slices 1-3 and training): a run of fewer phases gives none, and
    # ends with a line that says which phases ran in place of the result
    # line.
    full = phases == list(PHASES)
    for kernel_rows, name in ((rows, "K1"), (k2_rows, "K2"), (k3_rows, "K3")):
        by_path = {"slice1": total if name == "K1" else 0, "slice2": counts[name],
                   "slice3": counts3[name],
                   "train": train_counts["forward"] if name == "K1" else 0}
        for row in kernel_rows:
            row["launches"] = sum(by_path.values()) if full else None
            row["launches_by_path"] = by_path if full else None
    for row in grad_rows:
        row["launches"] = train_counts["input_grad"] if full else None
        row["launches_by_path"] = {"train": train_counts["input_grad"]} if full else None
    paths = {"slice1": f"slice 1 {total} K1",
             "slice2": f"slice 2 {counts['K1']} K1, {counts['K2']} K2 and {counts['K3']} K3",
             "train": f"training {train_counts['forward']} K1 forward and "
                      f"{train_counts['input_grad']} K1 input-gradient",
             "slice3": f"slice 3 {counts3['K1']} K1, {counts3['K2']} K2 and {counts3['K3']} K3"}
    print(
        "main path launches: " + ("; ".join(v for k, v in paths.items() if k in phases) or "none")
        + f"; total {time.perf_counter() - t_start:.1f} s; phase seconds "
        + ", ".join(f"{name} {t - t0:.1f}" for (_n, t0), (name, t) in zip(marks, marks[1:]))
    )
    rows += grad_rows + k2_rows + k3_rows
    print(json.dumps({"kernels": rows}))
    print(card)
    device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }
    if full:
        print(json.dumps({"ok": True, "device": device}))
    else:
        print(json.dumps({"partial": True, "phases": phases, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
