#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``hcunet_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU and the CUDA
toolkit::

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --phases k1     # build K1 and run phase 3 alone

``--phases`` takes a comma-separated subset of ``k1`` (3), ``k3`` (4),
``slice1`` (5), ``tconv`` (6), ``k2`` (7), ``slice2`` (8), ``blobs``
(9), ``train`` (10), ``slice3`` (11), ``cli`` (12), ``recurrent`` (13),
``rtrain`` (14), ``dtrain`` (15), ``mesh`` (16), ``hcat`` (17) and ``bench``
(18); phases 1, 2 (only the kernels the chosen phases launch) and 19 always
run.  A run of fewer
than all phases reports no launch counts (they are the whole main path's)
and ends with
``{"partial": true, "phases": [...], ...}`` instead of the result line.
Phases (any failure exits non-zero):

1. print the card (``nvidia-smi`` name and power limit) and turn TF32 off;
2. build kernels K1 (``hcunet_tpu_torch/csrc/conv3d_valid.cu``), K2
   (``csrc/edt_pass.cu``), K3 (``csrc/dot_blocked.cu``) and the float32
   transposed conv (``csrc/tconv3d_subpixel.cu``) into ``build/``,
   one ``nvcc`` each, all together, and the host flood
   (``csrc/watershed_host.cpp``) with ``g++`` beside them;
3. hold K1 against its plain version at the 15 valid-conv shapes of the
   production U-Net's serving forward at the tile geometry the port picks
   for this card, plus the TPU probe's case 1, in bfloat16 and float32,
   timing the kernel, the plain version and cuDNN's ``F.conv3d``; each row
   names K1's path (``k1_route``: ``ring`` or ``basic``), and the sums over
   the 15 layers and over the ring layers are printed beside cuDNN's and
   the bound's (float32: all 15 on the basic path); then the basic path at
   the distinct convs of an ``RDCNet`` forward at 256^2 x 10 in bfloat16
   and float32, padded inside the kernel (rows ``k1_rdcnet_*``);
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
   on the basic one) and, in float32, the transposed-conv kernel 3 times
   (one per up level), and that the float32 request agrees with a forward
   built on the plain conv and the plain transposed conv;
6. the float32 transposed conv's own kernel
   (``hcunet_tpu_torch/csrc/tconv3d_subpixel.cu``, built with ``-Xptxas
   -v`` once more to print its registers and spills) at the three up
   levels of one tile batch, into the concat buffer, against its plain
   version, timed with CUDA events beside its bound (the transposed
   conv's operations at 67 TFLOP/s; and that of every tap of the stacked
   parity convs, the zero padding's too), the plain version, K1's subpixel
   route (``ops/tconv.py::tconv_subpixel``: pad, one K1 launch with the
   four parity kernels stacked along Cout, interleave) and cuDNN's
   ``conv_transpose3d``,
   with the sums over the three levels;
7. hold K2 against its plain version, exactly, at the instance tile
   [1323, 1323, 15] of the main path, the TPU probe's 412^2 x 12 and
   1212^2 x 8, and a ragged shape, on a random mask, and at the first two
   on a sparse background and on the blob mask, timing both passes of
   each;
8. slice 2's path on the bench scene (2304, 2304, 15, 4): the uint8 mask
   from ``Segmenter(use_probability_map=False)``, candidates from
   ``predict_cell_candidates`` with a full-width ResNet50-FPN ``Detector``
   (random weights from a seed) on 9 tile positions of 1047^2 x 15 planes,
   and ``generate_unique_segmentation_mask(backend="device")`` on 4 instance
   tiles, checking that K2 launched 8 times and K1 15 per tile batch; then
   the instance stage once more under ``torch.profiler``;
9. the instance stage on a synthetic blob scene of one full tile: labels
   with K2 equal to labels with the plain EDT, and >= 90 % of the seeded
   blobs found;
10. training (slice 8's path): the JAX bench's fit
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
11. slice 3's path, ``analyze`` on the JAX bench's pipeline scene (1536 x
   1536 x 12, uint16, 160 blob cells; ``numchunks=3``, the auto tile
   geometry, the uint16 transfer, the ``"fused"`` host flood): a warm-up
   of the device stages on one chunk, a timed run (K1 15 launches per tile
   batch), a resume from its journal
   (K1 0 launches, the same cells), a float32-transfer run without overlap
   and without the detector under ``torch.profiler`` on the timed run's
   first chunk alone, whose mask the uint16 run's must match there within
   one half quantum, and the ``"fused"`` and ``"materialized"`` backends on
   the first eighth of that chunk's map, which must give equal labels; on
   the fitted weights of phase 10 where it ran
   (as the JAX bench does), else on the random ones;
12. the user entry points on the fitted weights of phase 10 where it ran,
    else the seeded ones, saved as a checkpoint beside the detector of
    phase 8 (``build_detector``): ``hcunet_tpu_torch.cli.main(["analyze",
    ...])`` (float32, as the command line serves a checkpoint) on a 384 x
    384 x 12 pipeline scene in ``.npy``, whose ``cells.csv`` must equal a
    direct ``analyze`` call's, K1 15 launches per tile batch on the basic
    path, and once more under ``torch.profiler`` with cuDNN free to pick
    its algorithms (fault F4: its map and cells, and those of the command
    at torch's TF32 defaults and of ``analyze()`` itself at them, against
    the checked run's; ``analyze()`` at torch's defaults must give the map
    within 1e-5 and the same ``cells.csv``, since the library turns TF32
    off for its own calls); fault F6: ``predict_cell_candidates`` with the
    float32 detector on the scene at torch's TF32 defaults through its
    unrepaired body against TF32 off (the gap printed), and the repaired
    entry point at those defaults equal to TF32 off; ``validate`` and
    ``train-unet`` (1 epoch, crop 128 x
    128 x 12) on a 2-sample
    ``.npy`` Stack; ``run_batch`` over a ``.npy`` scene with the command
    line's model loading, a second pass all cached; the ``hcat`` facade's
    ``analyze``, whose cells must equal the command line's;
13. the recurrent family's serving (``recurrent_phase``) at full width on
    the JAX bench's 256^2 x 10 geometry: a ``RecursiveUNet``
    (``RUNetConfig()``, 10 timesteps) and an ``RDCNet`` (``RDCNetConfig()``),
    random weights from the seed; K1 against its plain version at every
    distinct same-padding conv of both serving forwards (the stacked
    parity convs and RDCNet's five dilations among them) in bf16 and
    float32 on the unpadded input with the padding, timed beside cuDNN's
    padded ``F.conv3d``, the pad (0 on the basic path, which pads inside
    the kernel) and the bound; ``compile_recurrent_apply`` in bf16 at B=1 with ``split_x`` 1
    and 4 and (RecursiveUNet) a batch of 4, MVx/s, 200 K1 launches a
    RecursiveUNet forward (190 ring) and 71 an RDCNet one (all basic);
    float32 splits equal to unsplit, the K1 forward against one on the
    plain conv, bf16 within 4 % of the model's own eval forward;
    ``predict-recurrent`` through ``cli.main`` (batched and ``--split-x 4``)
    equal to ``compile_recurrent_apply``; one forward under the profiler;
14. the recurrent family's training (``rtrain_phase``) at full width:
    ``RecurrentTrainer`` on ``RUNetConfig()`` and ``RDCNetConfig()`` in
    float32 and bf16, 20 steps each on a synthetic 128 x 128 x 10 sample
    (train-recurrent's default crop) with the port's targets, the loss
    falling, ms a step, the peak memory and K1's launches by path each
    step (RecursiveUNet 170 forward, 169 input-gradient; RDCNet 71 and
    71); 3 K1 steps against 3 on the plain conv within the gaps of
    jittered plain runs; K1's input gradient at every shape of a training
    step (5^3 at dilations 1-5, Cin 9-64; the output gradient padded by
    d (k - 1) - p, inside the kernel on the basic path) against its plain
    version, timed beside cuDNN's dgrad of the padded conv, the ring path's
    pad of the output gradient (0 on the basic path) and the bound; fault F4's TF32
    gap of the first losses; the trained gate of
    ``tests/test_recurrent_trained_gate.py`` (RDCNet, 300 steps, at least
    half the cells matched at IoU >= 0.5); ``train-recurrent`` and
    ``predict-recurrent`` through ``cli.main``;
15. the detector's training (``dtrain_phase``) at full width: the
    ResNet50-FPN ``Detector`` (width 64, float32, 5 classes) on synthetic
    512 x 512 sections of 20-60 boxes: the first step's loss terms,
    running statistics and gradients on the card against the CPU's;
    fault F4's TF32 gap; ``DetectionTrainer`` at B=1 (20 steps, the loss
    falling) and B=4; ``evaluate_detections`` on its detections;
    ``pretrain_backbone`` (width 64, 100 steps) and
    ``seed_detector_backbone``; ``train-rcnn`` and ``pretrain-backbone``
    through ``cli.main``, and the detector checkpoint through ``analyze
    --detector``;
16. the multi-device paths (``mesh_phase``) over a mesh of distinct cards
    where the machine has enough, else of the card repeated (printed;
    times on one card are no scaling figure): ``Segmenter(mesh=spatial 2)``
    on a 1152^2 x 15 request at full width against one device (float32
    within 1e-5 of the output's scale, bf16 within 1 %, K1 15 launches per
    tile batch of every shard); ``analyze(mesh=spatial 2)`` on the ``cli``
    phase's scene in float32 with the ResNet50-FPN detector (the map within
    1e-5, ``cells.csv`` byte-equal, every chunk sharded);
    ``compile_recurrent_apply(mesh=spatial 2, split_x=2)`` for both
    families at 256^2 x 10 against ``split_x=2`` on one device (float32
    within 1e-5 of the scale, bf16 within 1 %); ``UNetTrainer`` on the
    2 x 2 x 2 mesh (5 float32 steps at the ``train`` crop),
    ``RecurrentTrainer`` (RDCNet, 3 steps) and ``DetectionTrainer``
    (ResNet50-FPN, 512^2, 2 steps) on data 2, each against one device on
    the global batch of 2 within rtol 1e-4, K1's launches checked each
    step; ms per request and per step beside the card's name and power
    limit;
17. the reference's driver surface (``hcat_phase``) through
    ``hcunet_tpu_torch.hcat``: the 8 import forms of the reference's
    drivers with their ``hcat`` prefix rewritten (no JAX, JAX package or
    ``hcat`` alias in ``sys.modules`` after them); ``r_unet.RecursiveUnet()``
    and ``RDCNet()`` on the card at the ``recurrent`` phase's 256^2 x 10
    (B=1, float32) within 1e-5 of the scale of the port's model applied
    directly on the same weights, K1 170 and 71 launches a forward (all
    basic); ``train.frcnn`` (2 epochs over 2 synthetic 512^2 sections, the
    ``dtrain`` phase's detector behind ``rcnn``) against
    ``DetectionTrainer`` on the same weights within rtol 1e-4; ``loss``'s
    four functions on CUDA tensors against CPU tensors within 1e-6
    relative; ``utils.pad_image_with_reflections`` on a CUDA tensor and the
    four window filters on a CUDA volume equal to the host's and the CPU's;
18. the benchmark module (``bench_phase``): ``python -m
    hcunet_tpu_torch.cli bench --headline --recurrent`` as a subprocess at
    full size (2304^2 x 15 tiled inference, the RecursiveUNet at 256^2 x
    10, ``split_x=4``) within a 240 s budget, exit code 0 and one value
    line per metric on an H100; the seeded inits of the bench's three
    models timed; the pipeline metric in this process on the ``cli``
    phase's 384^2 x 12 scene (the fit, the bf16 ResNet50-FPN detector, 4
    chunks) with a soft deadline 30 s away, K1 15 launches per tile batch
    of every chunk in every ``analyze`` call, ``analyze``'s four stages
    timed, and the bf16 detector's candidates;
19. print one JSON line of kernel rows (``launches``: the count over the
    paths, slices 1-3, training, the command
    line's ``analyze``, the recurrent forwards and fits, the mesh paths,
    the hcat facades and the in-process bench metric, with
    ``launches_by_path`` beside it; K1's input-gradient rows
    count the three training paths' input-gradient launches), the card
    line, and the result line.

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
# torch's TF32 settings as it starts, (cudnn.allow_tf32, cuda.matmul.allow_tf32):
# what a user's float32 run gets (fault F4 compares them with TF32 off)
TORCH_TF32_DEFAULTS = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
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
# the up levels, one transposed conv each
UP_LEVELS = ("up0", "up1", "up2")
# the command line's scene (a pipeline scene cut so that the host flood
# stays in seconds) and train-unet's crop (the default's z of 24 is deeper
# than the scene)
CLI_SCENE = (384, 384, 12)
CLI_CELLS = 12
CLI_CROP = (128, 128, 12)
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
    apply = compile_serving_apply(model, dtype=torch.bfloat16, device=dev, conv=recording_conv)
    apply(torch.zeros((tile_cfg.batch, *tile_in, model.config.in_channels), device=dev))
    if len(layers) != len(LAYER_NAMES):
        raise RuntimeError(f"expected {len(LAYER_NAMES)} valid convs, recorded {len(layers)}")
    return layers


def kernel_error(got, want) -> tuple[float, float]:
    """A K1 or K3 result's max error against the plain version's, and its
    tolerance.  float32: both sum in float32 in different orders.  bfloat16:
    both round the float32 sum once, so they differ by at most one bf16 ulp
    (2^-7 relative) where the sums straddle a rounding boundary."""
    scale = max(1.0, float(want.float().abs().max()))
    tol = 1e-5 * scale if want.dtype == torch.float32 else 2.0**-7 * scale
    return float((got.float() - want.float()).abs().max()), tol


def in_range_taps(n, p, k, d) -> int:
    """Along one axis of a conv over an input of size ``n`` zero-padded by
    ``p`` on each side (kernel ``k``, dilation ``d``): the number of (output,
    tap) pairs whose tap falls inside the input."""
    return sum(1 for o in range(n + 2 * p - d * (k - 1)) for t in range(k)
               if p <= o + d * t < p + n)


def check_kernel(name, x, w, b, relu, dilation=1, pad=None):
    """K1 against its plain version on one input (``w`` in ``x``'s dtype);
    returns a row.  ``pad``: for a same-padding conv (``conv_same``), the
    zero padding ``(px, py, pz)`` of the unpadded input ``x``: K1 is called
    with ``padding=pad`` as ``conv_same`` calls it.  The basic path pads
    inside the kernel (``pad_ms`` 0); on the ring path the wrapper pads a
    copy, and the row times the kernel on the padded copy and the pad
    alone (``pad_ms``).  The library time is cuDNN's ``F.conv3d`` with that
    padding, and the bound counts the bytes of the unpadded input and the
    operations of the taps inside it."""
    from hcunet_tpu_torch.ops.conv import (
        CONV3D_VALID,
        conv3d_valid,
        conv3d_valid_plain,
        conv3d_valid_route,
    )

    dtype, x_shape = x.dtype, tuple(x.shape)
    padding = (0, 0, 0) if pad is None else tuple(pad)
    k1_route = conv3d_valid_route(dtype, w.shape[3], w.shape[4])
    before = dict(CONV3D_VALID.route_launches)
    got = conv3d_valid(x, w, b, relu, dilation, padding)
    taken = [r for r, n in CONV3D_VALID.route_launches.items() if n != before[r]]
    if taken != [k1_route]:
        raise AssertionError(f"{name}: K1 took the path(s) {taken}, expected {k1_route}")
    want = conv3d_valid_plain(x, w, b, relu, dilation, padding)
    torch.cuda.synchronize()
    err, tol = kernel_error(got, want)
    del got, want

    w_cf = w.permute(4, 3, 0, 1, 2)
    b_lib = b.to(dtype)
    x_cf = x.permute(0, 4, 1, 2, 3)
    plain_ms = cuda_ms(lambda: conv3d_valid_plain(x, w, b, relu, dilation, padding))
    library_ms = cuda_ms(lambda: torch.nn.functional.conv3d(
        x_cf, w_cf, b_lib, padding=padding, dilation=dilation))
    pad_ms = None if pad is None else 0.0
    if pad is not None and k1_route == "ring":
        px, py, pz = pad
        pad_ms = cuda_ms(lambda: torch.nn.functional.pad(x, (0, 0, pz, pz, py, py, px, px)))
        xp = torch.nn.functional.pad(x, (0, 0, pz, pz, py, py, px, px)).contiguous()
        kernel_ms = cuda_ms(lambda: conv3d_valid(xp, w, b, relu, dilation))
        del xp
    else:
        kernel_ms = cuda_ms(lambda: conv3d_valid(x, w, b, relu, dilation, padding))
    del x_cf

    kx, ky, kz, cin, cout = w.shape
    out_vox = x_shape[0] * math.prod(
        s + 2 * p - dilation * (k - 1) for s, p, k in zip(x_shape[1:4], padding, (kx, ky, kz)))
    es = x.element_size()
    # only the (output, tap) pairs whose tap falls inside the input do work,
    # and only the input itself has to be read
    pairs = x_shape[0] * math.prod(
        in_range_taps(n, p, k, dilation) for n, p, k in zip(x_shape[1:4], padding, (kx, ky, kz)))
    x_elems = x.numel()
    flops = 2.0 * pairs * cin * cout
    nbytes = (x_elems + w.numel() + out_vox * cout) * es + b.numel() * 4
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
    if pad is not None:
        row["pad_ms"] = pad_ms
    print(
        f"  {row['name']:34s} {k1_route:5s} x{list(x_shape)} w{list(w.shape)}"
        + (f" d{dilation}" if dilation != 1 else "")
        + (f" p{list(padding)}" if pad is not None else "") + f" err {err:.3e} "
        f"(tol {tol:.3e}) kernel {kernel_ms:8.3f} ms plain {plain_ms:8.3f} ms "
        f"cudnn {library_ms:8.3f} ms bound {row['bound_ms']:7.3f} ms "
        f"({row['bound_by']}, {flops / kernel_ms / 1e9:.1f} TFLOP/s)"
        + (f" pad {pad_ms:.3f} ms" if pad is not None else ""),
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


def check_tconv(label, launches, batches, dtype) -> None:
    """The transposed convs of ``batches`` tile batches of the serving
    forward: in float32 3 launches of their own kernel a tile batch (one per
    up level), in bfloat16 none (cuDNN's)."""
    want = 3 * batches if dtype == torch.float32 else 0
    if launches != want:
        raise AssertionError(f"{label}: the transposed-conv kernel launched {launches} times, "
                             f"expected {want}")


@contextlib.contextmanager
def plain_tconv():
    """The serving forward's float32 transposed convs on their plain version
    (``tconv3d_subpixel_plain``: cuDNN's ``conv_transpose3d`` into the concat
    buffer), for the parity runs: no launch of their kernel."""
    import hcunet_tpu_torch.infer.compile as compile_mod
    from hcunet_tpu_torch.ops.tconv import tconv3d_subpixel_plain

    kernel = compile_mod.tconv3d_subpixel
    compile_mod.tconv3d_subpixel = tconv3d_subpixel_plain
    try:
        yield
    finally:
        compile_mod.tconv3d_subpixel = kernel


def run_request(seg, vol, kernel) -> tuple[np.ndarray, float, int, int]:
    """One ``predict`` with the launch count set to 0 just before it, K1's
    and the transposed-conv kernel's launches checked.  Returns the
    probabilities, seconds, K1's launches and peak device bytes."""
    from hcunet_tpu_torch.ops.tconv import TCONV3D_SUBPIXEL

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts([kernel])
    tconv0 = TCONV3D_SUBPIXEL.launches
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
    check_tconv(f"request {tuple(vol.shape)}", TCONV3D_SUBPIXEL.launches - tconv0, batches,
                seg.model.dtype)
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


def dot_sums(rows, dt, other=None) -> dict:
    """K3 over the 15 layer GEMMs in ``dt`` beside cuBLAS, the bound and,
    where given, the rows' ``other`` key; printed, and returned as a dict."""
    sel = [r for r in rows if r["name"] in {f"dot_blocked[{n},{dt}]" for n in LAYER_NAMES}]
    ms, lib, bound = (sum(r[k] for r in sel) for k in ("ms", "library_ms", "bound_ms"))
    sums = {"dtype": dt, "gemms": len(sel), "ms": ms, "library_ms": lib, "bound_ms": bound}
    extra = ""
    if other:
        sums[other] = sum(r[other] for r in sel)
        extra = f", {other} {sums[other]:.3f} ms"
    print(f"K3 {dt}, 15 layer GEMMs: kernel {ms:.3f} ms, cuBLAS {lib:.3f} ms (kernel/cuBLAS "
          f"{ms / lib:.3f}), bound {bound:.3f} ms (kernel at {100 * bound / ms:.1f}% of it){extra}",
          flush=True)
    return sums


def dot_phase(gemms, k1_rows, dev) -> list:
    """K3 at the TPU probe's shapes and at each K1 layer's GEMM shape, in
    bfloat16 and float32, each on the path it must take (``dot_cases``).
    Prints the sums over the 15 layer GEMMs beside cuBLAS and the bound,
    K3's time over K1's per layer (where the ``k1`` phase ran), and both as
    one JSON line ``{"k3_summary": ...}``."""
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        print(f"K3 vs plain, {dtype}:")
        for name, x_shape, n, pieces, route in dot_cases(gemms, dtype):
            rows.append(check_dot(name, x_shape, n, dtype, dev, pieces, route))
            torch.cuda.empty_cache()
    summary = {"sums": [dot_sums(rows, dt) for dt in ("bf16", "f32")], "k3_over_k1": {}}
    k1 = {r["name"]: r["ms"] for r in k1_rows}
    for dt in ("bf16", "f32") if k1_rows else ():
        print(f"K3 / K1 per layer, {dt} (K3: the product alone, on a dense A; K1: the conv):")
        ratios = {}
        tot1 = tot3 = 0.0
        for row in rows:
            m = re.fullmatch(rf"dot_blocked\[(.+),{dt}\]", row["name"])
            if not m or m.group(1) not in LAYER_NAMES:
                continue
            t1 = k1[f"conv3d_valid[{m.group(1)},{dt}]"]
            tot1, tot3 = tot1 + t1, tot3 + row["ms"]
            ratios[m.group(1)] = {"k1_ms": t1, "k3_ms": row["ms"], "k3_over_k1": row["ms"] / t1}
            print(f"  {m.group(1):12s} K1 {t1:8.3f} ms  K3 {row['ms']:8.3f} ms  K3/K1 {row['ms'] / t1:.3f}")
        print(f"  15 layers    K1 {tot1:8.3f} ms  K3 {tot3:8.3f} ms  K3/K1 {tot3 / tot1:.3f}")
        ratios["15 layers"] = {"k1_ms": tot1, "k3_ms": tot3, "k3_over_k1": tot3 / tot1}
        summary["k3_over_k1"][dt] = ratios
    print(json.dumps({"k3_summary": summary}), flush=True)
    return rows


def pipeline_scene(X, Y, Z, n_cells, seed=0):
    """The bench's pipeline scene (``hcunet_tpu_torch/benchmarks.py::
    _blob_scene``, the twin of ``hcunet_tpu/benchmarks.py:315``): a
    4-channel uint16 volume of gaussian-blob cells, and its truth map."""
    from hcunet_tpu_torch.benchmarks import _blob_scene

    return _blob_scene(X, Y, Z, n_cells, seed=seed)


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

        # the float32 transfer, sequential, under the profiler, on the timed
        # run's first chunk alone (numchunks=2 on it cuts none), without the
        # detector, which leaves its tail's flood nothing to do (a cut of
        # depth for the time limit, PERF.md section 4: the timed run drives
        # the detector and the flood)
        cfg32 = dataclasses.replace(cfg, prob_transfer_dtype="float32", numchunks=2)
        t0 = time.perf_counter()
        res32 = profile_device(
            "analyze on one chunk (float32 transfer, overlap off, no detector)",
            lambda: run(cfg32, "f32", vol[: chunk[0], : chunk[1]], None, overlap=False),
            {"K1": "conv3d_valid"},
        )
        print(f"analyze on one chunk (float32 transfer, overlap off, no detector) under the "
              f"profiler: {time.perf_counter() - t0:.3f} s; stage seconds "
              f"{ {k: round(v, 3) for k, v in res32.stage_seconds.items()} }; stage bytes "
              f"{res32.stage_bytes}", flush=True)
        tol = cfg.prob_scale / 131070 + 1e-6
        a, b = res.mask[: chunk[0], : chunk[1]], res32.mask
        bad = np.abs(a - b) > tol
        floor = cfg.prob_floor * cfg.prob_scale
        near = bad & (np.minimum(a, b) == 0) & (np.abs(np.maximum(a, b) - floor) <= 1e-4)
        n_bad, n_near = int(bad.sum()), int(near.sum())
        print(f"uint16 vs float32 transfer: max |d mask| {float(np.abs(a - b).max()):.3e} "
              f"(tolerance {tol:.3e}); {n_bad} voxels over, {n_near} of them within 1e-4 of the "
              f"floor {floor}; device path bit-reproducible: {reproducible}; cells on the "
              f"chunk {len(res32.cells)}", flush=True)
        if n_bad > n_near or (n_near and reproducible):
            raise AssertionError("the uint16 transfer's mask differs from the float32 run's")

        # "fused" == "materialized" on the first eighth of the chunk's map
        # (a cut of depth for the time limit, PERF.md section 4); the two
        # floods run at once (each releases the GIL)
        qx, qy = chunk[0] // 4, chunk[1] // 2
        prob = np.ascontiguousarray(res32.mask[:qx, :qy])
        cand = predict_cell_candidates(x[0][:qx, :qy][..., list(cfg.detection_channels)], det,
                                       device=dev)

        def flood(backend):
            t = time.perf_counter()
            out = generate_unique_segmentation_mask(
                prob, cand, dataclasses.replace(cfg.watershed, backend=backend), device=dev
            )[0]
            return out, time.perf_counter() - t

        with ThreadPoolExecutor(max_workers=2) as pool:
            (fused, fused_s), (mat, mat_s) = pool.map(flood, ("fused", "materialized"))
        equal = np.array_equal(fused, mat)
        print(f"chunk_1_1's first eighth {prob.shape}, {len(cand['scores'])} candidates: "
              f"fused {fused_s:.3f} s, "
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
    serving forward and the TPU probe's case 1, in bfloat16 and float32,
    then at the distinct convs of an ``RDCNet`` forward at
    ``RECURRENT_SCENE`` (all on the basic path, padded in the kernel), in
    bfloat16 and float32."""
    from hcunet_tpu_torch.config import RDCNetConfig
    from hcunet_tpu_torch.models.rdcnet import RDCNet

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
    rdcnet = build_recurrent(RDCNet(RDCNetConfig()), torch.Generator().manual_seed(SEED)).to(dev)
    rows += recurrent_k1_rows("rdcnet", rdcnet, dev, gen_dev, tag="k1_rdcnet")
    return rows


def slice1_phase(model, seg, dev, kernel) -> int:
    """Phase 5: three bf16 requests and a float32 one through K1 (and, in
    float32, the transposed-conv kernel), the float32 one against a forward
    on the plain conv and the plain transposed conv.  Returns K1's
    launches."""
    from hcunet_tpu_torch.infer.compile import compile_serving_apply
    from hcunet_tpu_torch.infer.serving import Segmenter
    from hcunet_tpu_torch.infer.tiling import predict_segmentation_mask
    from hcunet_tpu_torch.ops.conv import conv3d_valid_plain
    from hcunet_tpu_torch.ops.tconv import TCONV3D_SUBPIXEL

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
    tconv0 = TCONV3D_SUBPIXEL.launches
    with plain_tconv():
        p_p = predict_segmentation_mask(
            plain_apply, vols[0][None], cfg, tile_cfg, use_probability_map=True,
            device=dev,
        )[0, ..., 0].cpu().numpy()
    if TCONV3D_SUBPIXEL.launches != tconv0:
        raise AssertionError("the plain path launched the transposed-conv kernel")
    d32 = float(np.abs(p_k - p_p).max())
    print(
        f"float32 request {REQUESTS[0]}: K1 path (K1 and the transposed-conv kernel) vs plain "
        f"path (the plain conv and cuDNN's conv_transpose3d) max |dp| {d32:.3e} "
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
    """The bench's fit input (``hcunet_tpu_torch/benchmarks.py::_fit_batch``):
    the 256^2 crop of the pipeline scene, normalized ``(v - 0.5) / 0.5``
    after the integer unit scale, and the target ``truth > 0.3``."""
    from hcunet_tpu_torch.benchmarks import _fit_batch

    return _fit_batch(*pipeline_scene(*PIPELINE_SCENE, PIPELINE_CELLS, seed=SEED), crop=FIT_CROP)


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
    """The valid convs (the U-Net's, and the recurrent family's same-padding
    convs through ``conv_same``) on the plain version, their gradient by
    plain autograd (cuDNN), for the parity runs: no K1 launch.  ``jitter``: a
    ``torch.Generator`` on the card; each conv's float32 sum is then
    multiplied by ``1 + JITTER u`` (u uniform in [-1, 1], per element)
    before the cast to the working dtype, as another summation order would
    move it."""
    import hcunet_tpu_torch.ops.conv as conv_mod

    kernel = conv_mod.conv3d_valid

    def plain(x, w, b=None, relu=False, dilation=1, padding=0):
        if jitter is None:
            return conv_mod.conv3d_valid_plain(x, w, b, relu, dilation, padding)
        y = conv_mod.conv3d_valid_plain(x.float(), w.float(), b, relu, dilation, padding)
        u = torch.rand(y.shape, generator=jitter, device=y.device) * 2 - 1
        return (y * (1 + JITTER * u)).to(x.dtype)

    # conv_same binds its conv as a default at definition: swap that too
    same_kernel = conv_mod.conv_same.__kwdefaults__["conv"]
    conv_mod.conv3d_valid = plain
    conv_mod.conv_same.__kwdefaults__["conv"] = plain
    try:
        yield
    finally:
        conv_mod.conv3d_valid = kernel
        conv_mod.conv_same.__kwdefaults__["conv"] = same_kernel


@contextlib.contextmanager
def recording_input_grad(records):
    """Record ``(gy shape, w, dilation, padding)`` of every input-gradient
    call while it runs as usual (through K1 on the card)."""
    import hcunet_tpu_torch.ops.conv as conv_mod

    kernel = conv_mod.conv3d_valid_input_grad

    def record(gy, w, dilation=1, padding=0):
        records.append((tuple(gy.shape), w.detach().clone(), dilation, padding))
        return kernel(gy, w, dilation, padding)

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


def run_gaps(run_a, run_b, start, lr=FIT_LR) -> dict:
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
    per.update(trajectory_gaps(var_a, var_b, start, lr, PARITY_STEPS))
    for (kind, path), v in per.items():
        if v >= out.get(kind, (-1.0, None))[0]:
            out[kind] = (v, "/".join(path))
    return out


def trajectory_gap(kernel, plain, jittered, start, dtype, lr=FIT_LR) -> str:
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
    got = run_gaps(kernel, plain, start, lr)
    noise = [run_gaps(j, plain, start, lr) for j in jittered]
    factor, floor = JITTER_FACTOR[dtype], GAP_FLOOR[dtype]
    parts, bad = [], []
    for kind in floor:
        if kind not in got:  # no tensor of that kind (RDCNet keeps no running statistics)
            parts.append(f"no {kind} gap")
            continue
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


def check_input_grad(name, gy, w, dilation, pad=None) -> dict:
    """K1's input gradient against its plain version on one output gradient
    ``gy`` (``w`` in its dtype); returns a row.  ``pad``: for a same-padding
    conv (``conv_same``), the zero padding of its input; the input gradient
    is the unpadded input's (K1 on ``gy`` with padding d (k - 1) - pad: in
    the kernel on the basic path, ``pad_ms`` 0; a padded copy on the ring
    path, where the row times the kernel on the padded copy and the
    ``F.pad`` alone, ``pad_ms``, as :func:`check_kernel` does; the kernel
    time is K1's launch on the flipped kernel, without the wrapper's flip
    and pad), the library time is cuDNN's dgrad of the padded conv and the
    bound counts the unpadded input's bytes and only the (voxel, tap) pairs
    inside it (``in_range_taps``), as the same-pad forward's row does."""
    from hcunet_tpu_torch.ops.conv import (
        CONV3D_VALID_INPUT_GRAD,
        conv3d_valid,
        conv3d_valid_input_grad,
        conv3d_valid_input_grad_plain,
        conv3d_valid_route,
    )

    dtype = gy.dtype
    kx, ky, kz, cin, cout = w.shape
    k1_route = conv3d_valid_route(dtype, cout, cin)
    pads = (0, 0, 0) if pad is None else tuple(pad)
    before = dict(CONV3D_VALID_INPUT_GRAD.route_launches)
    got = conv3d_valid_input_grad(gy, w, dilation, pads)
    taken = [r for r, n in CONV3D_VALID_INPUT_GRAD.route_launches.items() if n != before[r]]
    if taken != [k1_route]:
        raise AssertionError(f"{name}: K1 took the path(s) {taken}, expected {k1_route}")
    want = conv3d_valid_input_grad_plain(gy, w, dilation, pads)
    torch.cuda.synchronize()
    err, tol = kernel_error(got, want)
    in_size = (gy.shape[0], cin, *got.shape[1:4])
    del got, want

    gy_cf = gy.permute(0, 4, 1, 2, 3)
    w_cf = w.permute(4, 3, 0, 1, 2)
    plain_ms = cuda_ms(lambda: conv3d_valid_input_grad_plain(gy, w, dilation, pads))
    library_ms = cuda_ms(lambda: torch.nn.grad.conv3d_input(
        in_size, w_cf, gy_cf, dilation=dilation, padding=pads))
    es = gy.element_size()
    dils = (dilation,) * 3 if isinstance(dilation, int) else tuple(dilation)
    gp = [d * (k - 1) - p for d, k, p in zip(dils, (kx, ky, kz), pads)]
    wt = w.flip((0, 1, 2)).transpose(3, 4).contiguous()
    pad_ms = 0.0
    if k1_route == "ring":
        pad = (0, 0, gp[2], gp[2], gp[1], gp[1], gp[0], gp[0])
        pad_ms = cuda_ms(lambda: torch.nn.functional.pad(gy, pad))
        gyp = torch.nn.functional.pad(gy, pad).contiguous()
        kernel_ms = cuda_ms(lambda: conv3d_valid(gyp, wt, dilation=dils))
        del gyp
    else:
        kernel_ms = cuda_ms(lambda: conv3d_valid(gy, wt, dilation=dils, padding=gp))
    del wt
    taps = math.prod(in_range_taps(n, p, k, d)
                     for n, p, k, d in zip(in_size[2:], pads, (kx, ky, kz), dils))
    flops = 2.0 * gy.shape[0] * taps * cin * cout
    nbytes = (gy.numel() + w.numel() + math.prod(in_size)) * es
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    dt = "bf16" if dtype == torch.bfloat16 else "f32"
    row = {
        "name": f"conv3d_valid_input_grad[{name},{dt}]",
        "route": "cuda",
        "k1_route": k1_route,
        "source": "hcunet_tpu_torch/csrc/conv3d_valid.cu",
        "replaces": ("hcunet_tpu/ops/conv.py:90 (XLA's input gradient of lax.conv_general_dilated; "
                     "no Pallas kernel)" if pad is None else
                     "hcunet_tpu/ops/conv.py:105 (conv_same: XLA's input gradient of its padded "
                     "lax.conv_general_dilated; no Pallas kernel)"),
        "launches": None,
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
        "pad_ms": pad_ms,
    }
    print(
        f"  {row['name']:44s} {k1_route:5s} gy{list(gy.shape)} w{list(w.shape)} err {err:.3e} "
        f"(tol {tol:.3e}) kernel {kernel_ms:8.3f} ms plain {plain_ms:8.3f} ms "
        f"cudnn dgrad {library_ms:8.3f} ms bound {row['bound_ms']:7.3f} ms "
        f"({row['bound_by']}, {flops / kernel_ms / 1e9:.1f} TFLOP/s) pad {pad_ms:.3f} ms",
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
    got_shapes = [(w.shape[3], w.shape[4]) for _s, w, _d, _p in records]
    if got_shapes != shapes:
        raise AssertionError(f"recorded input gradients {got_shapes}, expected {shapes}")
    gen_dev = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        print(f"K1 input gradient vs plain, {dtype}:")
        for name, (gy_shape, w, dil, _p) in zip(names, records):
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


def up_level_inputs(layers) -> list:
    """The input shape ``[B, X, Y, Z, Cin]`` of each up level's transposed
    conv: the output of the valid conv before the level's first, from the
    convs :func:`record_layers` records."""
    shapes = []
    for name in UP_LEVELS:
        x_shape, w, _b, _r = layers[LAYER_NAMES.index(f"{name}.conv1") - 1]
        spatial = [s - k + 1 for s, k in zip(x_shape[1:4], w.shape[:3])]
        shapes.append((x_shape[0], *spatial, w.shape[-1]))
    return shapes


def tconv_levels(model, x_shapes, gen, dtype=torch.bfloat16):
    """Per up level of the serving forward, the transposed conv's inputs in
    ``dtype``: ``(name, x, w_up, b_up, w_sub, b_sub, stride)``, ``x`` random
    from ``gen`` (on its device) at the level's input shape in ``x_shapes``
    (:func:`up_level_inputs`), ``w_up``/``b_up`` the model's transposed conv
    and ``w_sub``/``b_sub`` its stacked parity weights, both from the
    float32 weights."""
    from hcunet_tpu_torch.models.unet import tconv_weight_channels_last
    from hcunet_tpu_torch.ops.tconv import subpixel_tconv_weights

    stride = model.config.upsample_stride
    dev = gen.device
    for name, step, x_shape in zip(UP_LEVELS, model.up_steps, x_shapes):
        x = torch.randn(x_shape, generator=gen, device=dev).to(dtype)
        w_up = tconv_weight_channels_last(step.up_conv.weight).detach().float().cpu()
        b_up = step.up_conv.bias.detach().float().to(dev)
        w_sub = subpixel_tconv_weights(w_up).to(dev, dtype)
        yield (name, x, w_up.to(dev, dtype).contiguous(), b_up, w_sub, b_up.repeat(4), stride)


def ptxas_report(source: str) -> str:
    """``nvcc -Xptxas -v``'s lines on ``csrc/<source>`` (registers, shared
    memory and spills of each kernel), from a build into a scratch file."""
    from hcunet_tpu_torch.csrc import CSRC_DIR, NVCC_FLAGS, nvcc_path

    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", os.path.join(tmp, "lib.so"),
             str(CSRC_DIR / source)], capture_output=True, text=True, check=True)
    return "\n".join(line for line in proc.stderr.splitlines()
                     if re.search(r"registers|spill|Compiling entry", line))


def tconv_phase(model, dev) -> list:
    """The float32 transposed conv's own kernel (``ops/tconv.py::
    tconv3d_subpixel``) at the three up levels of one tile batch, each into
    a concat buffer of the transposed conv's extent (the up levels' common
    extent at the production tile): held to its plain version at K1's
    float32 tolerance, then timed with CUDA events in turns (kernel, plain,
    K1's subpixel route ``ops/tconv.py::tconv_subpixel``, cuDNN's
    ``conv_transpose3d``, and back) beside its bound, the transposed conv's
    operations (``2 B X Y Z kx ky kz Cin Cout``) over the float32 peak, and
    beside ``padded_bound_ms``, the same for every tap of the stacked
    parity convs, the zero padding's too, which the kernel computes.
    Returns the rows."""
    from hcunet_tpu_torch.infer.serving import Segmenter
    from hcunet_tpu_torch.ops.conv import conv_transpose_torch
    from hcunet_tpu_torch.ops.tconv import (
        TCONV3D_SUBPIXEL,
        tconv3d_subpixel,
        tconv3d_subpixel_extent,
        tconv3d_subpixel_plain,
        tconv_subpixel,
    )

    t0 = time.perf_counter()
    print(f"tconv3d_subpixel, -Xptxas -v:\n{ptxas_report('tconv3d_subpixel.cu')}", flush=True)
    seg = Segmenter(model, dtype=torch.bfloat16, device=dev)
    x_shapes = up_level_inputs(record_layers(seg.model, seg.tile_cfg, dev))
    gen_dev = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    print(f"float32 transposed convs of one tile batch of {seg.tile_cfg}: kernel vs plain, "
          "K1's subpixel route and cuDNN, in turns:", flush=True)
    for name, x, w_up, b_up, w_sub, b_sub, stride in tconv_levels(
            seg.model, x_shapes, gen_dev, torch.float32):
        cout = w_up.shape[-1]
        out = torch.empty((x.shape[0], *tconv3d_subpixel_extent(x.shape, w_sub.shape), 2 * cout),
                          device=dev)
        want = torch.empty_like(out)
        before = TCONV3D_SUBPIXEL.launches
        tconv3d_subpixel(x, w_sub, b_sub, out)
        tconv3d_subpixel_plain(x, w_sub, b_sub, want)
        torch.cuda.synchronize()
        if TCONV3D_SUBPIXEL.launches != before + 1:
            raise AssertionError(f"{name}: the kernel launched {TCONV3D_SUBPIXEL.launches - before}"
                                 " times, expected 1")
        err, tol = kernel_error(out[..., :cout], want[..., :cout])
        del want
        fns = {
            "kernel": lambda: tconv3d_subpixel(x, w_sub, b_sub, out),
            "plain": lambda: tconv3d_subpixel_plain(x, w_sub, b_sub, out),
            "k1_route": lambda: tconv_subpixel(x, w_sub, b_sub),
            "cudnn": lambda: conv_transpose_torch(x, w_up, b_up, stride=stride,
                                                  accum_dtype=torch.float32),
        }
        order = list(fns) + list(fns)[::-1]
        ms = {k: 0.0 for k in fns}
        for k in order:
            ms[k] += cuda_ms(fns[k]) / 2
        hx, hy, kz = w_sub.shape[:3]
        B, X, Y, Z, cin = x.shape
        flops = 2.0 * B * X * Y * Z * (2 * hx) * (2 * hy) * kz * cin * cout
        padded = 2.0 * B * (X + hx - 1) * (Y + hy - 1) * (Z + kz - 1) * 4 * cout * hx * hy * kz * cin
        bound = flops / H100_F32_FLOPS * 1e3
        row = {
            "name": f"tconv3d_subpixel[{name},f32]",
            "route": "cuda",
            "source": "hcunet_tpu_torch/csrc/tconv3d_subpixel.cu",
            "replaces": None,
            "launches": None,
            "max_abs_err": err,
            "ms": ms["kernel"],
            "plain_ms": ms["plain"],
            "bound_ms": bound,
            "bound_by": "operations",
            "padded_bound_ms": padded / H100_F32_FLOPS * 1e3,
            "library_ms": ms["cudnn"],
            "k1_route_ms": ms["k1_route"],
        }
        print(f"  {row['name']:32s} x{list(x.shape)} -> out{list(out.shape)} err {err:.3e} "
              f"(tol {tol:.3e}) kernel {ms['kernel']:8.3f} ms plain {ms['plain']:8.3f} ms "
              f"K1 route {ms['k1_route']:8.3f} ms cuDNN {ms['cudnn']:8.3f} ms bound "
              f"{bound:7.3f} ms ({flops / ms['kernel'] / 1e9:.1f} TFLOP/s, "
              f"{100 * bound / ms['kernel']:.1f}% of the peak; every padded tap "
              f"{row['padded_bound_ms']:7.3f} ms, {100 * padded / flops - 100:.1f}% more)",
              flush=True)
        if not err <= tol:
            raise AssertionError(f"{row['name']}: max error {err} > tolerance {tol}")
        rows.append(row)
        del x, out
        torch.cuda.empty_cache()
    tot = {k: sum(r[k] for r in rows) for k in ("ms", "plain_ms", "k1_route_ms", "library_ms",
                                                 "bound_ms", "padded_bound_ms")}
    print(f"float32 transposed convs, 3 up levels of one tile batch: kernel {tot['ms']:.3f} ms, "
          f"plain {tot['plain_ms']:.3f} ms, K1's subpixel route {tot['k1_route_ms']:.3f} ms, "
          f"cuDNN conv_transpose3d {tot['library_ms']:.3f} ms, bound {tot['bound_ms']:.3f} ms "
          f"(kernel at {100 * tot['bound_ms'] / tot['ms']:.1f}% of the float32 peak; "
          f"{100 * tot['padded_bound_ms'] / tot['ms']:.1f}% counting every padded tap, bound "
          f"{tot['padded_bound_ms']:.3f} ms); tconv phase {time.perf_counter() - t0:.1f} s",
          flush=True)
    return rows


def save_unet_and_detector(model, det, root) -> tuple:
    """``model`` and ``det`` as checkpoints in the JAX package's format,
    written by the port: ``(unet path, detector path)``."""
    from hcunet_tpu_torch.utils.checkpoint import save_checkpoint
    from hcunet_tpu_torch.utils.port_jax import (
        jax_variables_from_detector_state_dict,
        jax_variables_from_unet_state_dict,
    )

    unet = os.path.join(root, "unet.hcunet")
    save_checkpoint(unet, jax_variables_from_unet_state_dict(model.state_dict(), model.config),
                    model.config, snapshot_sources=False)
    detector = os.path.join(root, "detector.hcunet")
    save_checkpoint(detector, jax_variables_from_detector_state_dict(det.state_dict()),
                    det.config, snapshot_sources=False)
    return unet, detector


def write_stack_sample(root, name, seed) -> np.ndarray:
    """A pipeline scene of ``CLI_SCENE`` as a Stack sample in the on-disk
    layout: ``<name>.npy`` [Z, Y, X, C] uint16, ``<name>.mask.npy`` 0/255
    (truth > 0.3) and ``<name>.pwl.npy``.  Returns the volume [X, Y, Z, C]."""
    vol, truth = pipeline_scene(*CLI_SCENE, CLI_CELLS, seed=seed)
    np.save(os.path.join(root, f"{name}.npy"), np.ascontiguousarray(vol.transpose(2, 1, 0, 3)))
    mask = np.where(truth > 0.3, 255, 0).astype(np.uint8)
    np.save(os.path.join(root, f"{name}.mask.npy"), np.ascontiguousarray(mask.transpose(2, 1, 0)))
    np.save(os.path.join(root, f"{name}.pwl.npy"), np.ascontiguousarray(truth.transpose(2, 1, 0)))
    return vol


def cli_main(argv) -> object:
    """``hcunet_tpu_torch.cli.main(argv)``, which must return 0, and the JSON
    it printed last."""
    import io

    from hcunet_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    out = buf.getvalue()
    if rc != 0:
        raise AssertionError(f"hcunet-torch {' '.join(argv)} returned {rc}: {out}")
    lines = out.strip().splitlines()
    for i in range(len(lines) - 1, -1, -1):
        if lines[i].startswith(("{", "[")):
            with contextlib.suppress(json.JSONDecodeError):
                return json.loads("\n".join(lines[i:]))
    raise AssertionError(f"hcunet-torch {' '.join(argv)} printed no JSON: {out!r}")


@contextlib.contextmanager
def capture_analyze(results, label):
    """Keep, under ``results[label]``, the ``AnalyzeResult`` of the
    ``analyze`` call the command line makes in the block."""
    import hcunet_tpu_torch.infer.pipeline as pipeline

    inner = pipeline.analyze

    def keep(*args, **kwargs):
        results[label] = inner(*args, **kwargs)
        return results[label]

    pipeline.analyze = keep
    try:
        yield
    finally:
        pipeline.analyze = inner


def match_candidates(got, want) -> tuple:
    """Each of ``got``'s candidates matched to the nearest of ``want``'s on
    its z plane with its label (the largest box coordinate difference):
    ``(max |d score| over the matches within 1 px, max |d box| over them,
    candidates of got without such a match)``."""
    worst_score = worst_box = 0.0
    unmatched = 0
    for i in range(len(got["scores"])):
        same = (want["z_level"] == got["z_level"][i]) & (want["labels"] == got["labels"][i])
        if not same.any():
            unmatched += 1
            continue
        dist = np.abs(want["boxes"][same] - got["boxes"][i]).max(1)
        j = int(dist.argmin())
        if dist[j] > 1.0:
            unmatched += 1
            continue
        worst_box = max(worst_box, float(dist[j]))
        worst_score = max(worst_score, abs(float(want["scores"][same][j] - got["scores"][i])))
    return worst_score, worst_box, unmatched


def f6_detector(det, vol, dev) -> None:
    """Fault F6 for the detection entry points: ``predict_cell_candidates``
    with the float32 detector on the ``cli`` scene (normalized as
    ``analyze`` does, the detection channels) with TF32 off, against its
    unrepaired body (``dispatch_cell_candidates.__wrapped__``, before the
    ``exact_float32`` wrap) at torch's TF32 defaults: the measured gap.
    The repaired entry point at torch's defaults must equal the TF32-off
    run (``cudnn.deterministic`` on)."""
    from hcunet_tpu_torch.config import PipelineConfig
    from hcunet_tpu_torch.infer.detect import (
        collect_cell_candidates,
        dispatch_cell_candidates,
        predict_cell_candidates,
    )

    x = torch.from_numpy(vol.astype(np.float32)).to(dev)
    image = ((x / 65536.0 - 0.5) / 0.5)[..., list(PipelineConfig().detection_channels)]
    with tf32(False):
        off = predict_cell_candidates(image, det, device=dev)
    with tf32(True):
        unrepaired = collect_cell_candidates(
            dispatch_cell_candidates.__wrapped__(image, det, device=dev))
        repaired = predict_cell_candidates(image, det, device=dev)
    d_score, d_box, unmatched = match_candidates(unrepaired, off)
    equal = all(np.array_equal(repaired[k], off[k]) for k in off)
    print(f"F6 predict_cell_candidates, float32 ResNet50-FPN on {tuple(image.shape)}: TF32 off "
          f"{len(off['scores'])} boxes; unrepaired at torch's TF32 defaults "
          f"{len(unrepaired['scores'])} boxes, max |d score| {d_score:.3e} and max |d box| "
          f"{d_box:.3e} px over the matched ones, {unmatched} unmatched; the repaired entry "
          f"point at torch's defaults {len(repaired['scores'])} boxes, equal to TF32 off: "
          f"{equal}", flush=True)
    if not equal or not len(off["scores"]):
        raise AssertionError("F6: predict_cell_candidates at torch's TF32 defaults parts from "
                             "TF32 off")


def cli_phase(model, dev, kernel, keep=None) -> int:
    """The user entry points on the card: the command line's ``analyze``
    (float32, as it serves a checkpoint) on a ``CLI_SCENE`` pipeline scene
    against a direct ``analyze()`` on the same models, ``validate`` and
    ``train-unet`` on a 2-sample ``.npy`` Stack, ``run_batch`` over one
    ``.npy`` scene with the command line's model loading (a second pass
    all cached), and the ``hcat`` facade's ``analyze`` against the command
    line's cells; fault F4: the command line's map and cells with
    ``cudnn.deterministic`` off and at torch's TF32 defaults (which
    ``cli.main`` turns off), and ``analyze()``'s at those defaults, against
    the checked run.  Returns K1's launches on the command line's ``analyze``
    (the path, with the counts set to 0 just before it), all on the basic
    path (float32).  ``keep`` (a dict) receives the direct ``analyze``'s
    inputs, result, ``cells.csv`` and seconds, the mesh phase's reference."""
    from hcunet_tpu_torch import PipelineConfig, analyze, compat
    from hcunet_tpu_torch.apps.batch import run_batch
    from hcunet_tpu_torch.cli import _load_models
    from hcunet_tpu_torch.config import TileConfig
    from hcunet_tpu_torch.infer.pipeline import _load_volume
    from hcunet_tpu_torch.ops.tconv import TCONV3D_SUBPIXEL
    from hcunet_tpu_torch.utils.checkpoint import load_unet

    t_phase = time.perf_counter()
    marks = []
    root = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    torch.backends.cudnn.deterministic = True
    try:
        det = build_detector(dev)
        unet_path, det_path = save_unet_and_detector(model, det, root)
        stack = os.path.join(root, "stack")
        os.makedirs(stack)
        write_stack_sample(stack, "s0", SEED)
        write_stack_sample(stack, "s1", SEED + 1)
        vol_path = os.path.join(stack, "s0.npy")
        marks.append(("set-up", time.perf_counter()))

        # analyze through the command line, counted as the path
        out = os.path.join(root, "cli_out")
        torch.cuda.synchronize()
        reset_counts([kernel])
        tconv0 = TCONV3D_SUBPIXEL.launches
        t0 = time.perf_counter()
        info = cli_main(["analyze", vol_path, "--unet", unet_path, "--detector", det_path,
                         "--numchunks", "2", "--no-cochlea", "--out", out])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches, routes = kernel.launches, dict(kernel.route_launches)
        tconv = TCONV3D_SUBPIXEL.launches - tconv0
        marks.append(("cli analyze", time.perf_counter()))
        vol = _load_volume(vol_path)
        tiles = TileConfig()
        batches = unet_tile_batches(vol.shape[:3], tiles)
        want = {"basic": 15 * batches, "ring": 0}
        print(f"cli analyze {CLI_SCENE} (float32, numchunks 2 = one chunk, {tiles}): "
              f"{cli_s:.3f} s, {info}, K1 {launches} launches {routes} (expected {want}), "
              f"the transposed-conv kernel {tconv} (expected {3 * batches})", flush=True)
        if routes != want or launches != 15 * batches:
            raise AssertionError(f"cli analyze launched K1 {routes}, expected {want}")
        check_tconv("cli analyze", tconv, batches, torch.float32)

        # the same through analyze() directly, on the same models
        umodel, apply, detector = _load_models(unet_path, det_path, dev)
        t0 = time.perf_counter()
        direct = analyze(volume=vol, unet_apply=apply, detector=detector,
                         cfg=PipelineConfig(numchunks=2, unet=umodel.config),
                         work_dir=os.path.join(root, "direct"), fit_cochlea=False, device=dev)
        torch.cuda.synchronize()
        direct_s = time.perf_counter() - t0
        with open(os.path.join(out, "cells.csv"), "rb") as f:
            cli_csv = f.read()
        with open(os.path.join(root, "direct", "cells.csv"), "rb") as f:
            direct_csv = f.read()
        same = direct_csv == cli_csv
        if keep is not None:
            keep.update(vol=vol, apply=apply, detector=detector, cfg=umodel.config,
                        result=direct, csv=direct_csv, seconds=direct_s)
        print(f"direct analyze(): {len(direct.cells)} cells, cells.csv equal to the command "
              f"line's: {same}", flush=True)
        if not same or len(direct.cells) != info["cells"]:
            raise AssertionError("the command line's analyze differs from analyze()")
        marks.append(("direct analyze", time.perf_counter()))

        # the command as a user runs it (cuDNN free to pick its algorithms),
        # under the profiler
        torch.backends.cudnn.deterministic = False
        maps = {}
        with capture_analyze(maps, "deterministic off"):
            profile_device(
                "cli analyze (cudnn.deterministic off)",
                lambda: cli_main(["analyze", vol_path, "--unet", unet_path, "--detector", det_path,
                                  "--numchunks", "2", "--no-cochlea",
                                  "--out", os.path.join(root, "cli_profiled")]),
                {"K1": "conv3d_valid", "conv_transpose3d (cuDNN dgrad)": "dgrad"},
            )
        marks.append(("cli analyze, profiled", time.perf_counter()))
        # fault F4: that run, the command line at torch's TF32 defaults, and
        # analyze() itself at those defaults, against the checked run
        with tf32(True), capture_analyze(maps, "TF32 at torch's defaults"):
            cli_main(["analyze", vol_path, "--unet", unet_path, "--detector", det_path,
                      "--numchunks", "2", "--no-cochlea", "--out", os.path.join(root, "cli_tf32")])
        with tf32(True):
            maps["analyze() at torch's TF32 defaults"] = analyze(
                volume=vol, unet_apply=apply, detector=detector,
                cfg=PipelineConfig(numchunks=2, unet=umodel.config),
                work_dir=os.path.join(root, "direct_tf32"), fit_cochlea=False, device=dev)
        outs = {"deterministic off": "cli_profiled", "TF32 at torch's defaults": "cli_tf32",
                "analyze() at torch's TF32 defaults": "direct_tf32"}
        for label, result in maps.items():
            with open(os.path.join(root, outs[label], "cells.csv"), "rb") as f:
                same_csv = f.read() == cli_csv
            dp = float(np.abs(result.mask.astype(np.float64) - direct.mask).max())
            print(f"F4 {label} (float32): max |dp| {dp:.3e} against the checked run "
                  f"(deterministic, TF32 off); cells {len(result.cells)} against "
                  f"{len(direct.cells)}; cells.csv byte-equal: {same_csv}", flush=True)
            # the command line pins TF32 off (cli.pin_float32): a user's
            # float32 analyze keeps the float32 request's gate and its cells
            if not label.startswith("analyze()") and (
                    dp > 1e-4 or len(result.cells) != len(direct.cells)):
                raise AssertionError(f"F4: the command line's {label} run parts from the "
                                     f"checked run")
            # the library turns TF32 off for its own calls (exact_float32):
            # analyze() at torch's defaults gives the pinned map and cells
            if label.startswith("analyze()") and (dp > 1e-5 or not same_csv):
                raise AssertionError(f"F4: {label} parts from the pinned run: max |dp| "
                                     f"{dp:.3e}, cells.csv byte-equal {same_csv}")
        torch.backends.cudnn.deterministic = True
        marks.append(("F4", time.perf_counter()))
        f6_detector(det, vol, dev)
        marks.append(("F6", time.perf_counter()))

        summary = cli_main(["validate", stack, "--unet", unet_path])
        print(f"cli validate: {summary}", flush=True)
        if len(summary) != 2 or not all(0.0 <= r["dice"] <= 1.0 for r in summary):
            raise AssertionError(f"bad validate summary {summary}")
        marks.append(("cli validate", time.perf_counter()))

        ckpt = os.path.join(root, "trained.hcunet")
        info_t = cli_main(["train-unet", stack, "--out", ckpt, "--epochs", "1",
                           "--crop", *map(str, CLI_CROP)])
        trained, _v, hyper = load_unet(ckpt)
        finite = all(bool(torch.isfinite(p).all()) for p in trained.state_dict().values())
        print(f"cli train-unet (1 epoch, 2 samples, crop {CLI_CROP}): {info_t}, "
              f"learning_rate {hyper['learning_rate']}, weights finite: {finite}", flush=True)
        if not finite or info_t != {"checkpoint": ckpt}:
            raise AssertionError("train-unet wrote a bad checkpoint")
        marks.append(("cli train-unet", time.perf_counter()))

        # run_batch over one scene (a cut of depth for the time limit), then
        # again, all cached
        batch_root = os.path.join(root, "batch")
        os.makedirs(batch_root)
        shutil.copy(os.path.join(stack, "s0.npy"), os.path.join(batch_root, "s0.npy"))

        def one(img, out_dir):
            analyze(img, unet_apply=apply, detector=detector,
                    cfg=PipelineConfig(numchunks=2, unet=umodel.config), work_dir=out_dir,
                    fit_cochlea=False, device=dev)

        first = run_batch(batch_root, one, pattern="**/*.npy")
        again = run_batch(batch_root, one, pattern="**/*.npy")
        print(f"run_batch over a .npy scene: {[(os.path.basename(r['image']), r['state']) for r in first]}; "
              f"again: cached {[r.get('cached') for r in again]}", flush=True)
        if [r["state"] for r in first] != ["done"] or [r.get("cached") for r in again] != [True]:
            raise AssertionError("run_batch did not analyze both scenes, or reran one")
        with open(os.path.join(batch_root, "s0_cellBycell", "cells.csv"), "rb") as f:
            if f.read() != cli_csv:
                raise AssertionError("run_batch's cells differ from the command line's")
        marks.append(("batch", time.perf_counter()))

        cfg = umodel.config
        unet = compat.unet(
            image_dimensions=3, in_channels=cfg.in_channels, out_channels=cfg.out_channels,
            feature_sizes=list(cfg.feature_sizes),
            kernel={"conv1": cfg.kernel1, "conv2": cfg.kernel2},
            upsample_kernel=cfg.upsample_kernel, max_pool_kernel=cfg.max_pool_kernel,
            upsample_stride=cfg.upsample_stride, groups=cfg.groups, device=dev,
        )
        unet.load(unet_path)
        rcnn = compat.rcnn(det_path, device=dev)
        _mask, _uniq, cells = compat.analyze(
            volume=vol, numchunks=2, path_chunk_storage=os.path.join(root, "facade"),
            unet_model=unet, faster_rcnn=rcnn, tiles=tiles, fit_cochlea=False,
            write_all_cells_pkl=False,
        )
        key = [(c.unique_id, tuple(c.center), c.volume) for c in cells]
        same = key == [(c.unique_id, tuple(c.center), c.volume) for c in direct.cells]
        print(f"facade analyze: {len(cells)} cells, equal to the command line's: {same}",
              flush=True)
        if not same:
            raise AssertionError("the facade's cells differ from the command line's")
        marks.append(("facade", time.perf_counter()))
    finally:
        torch.backends.cudnn.deterministic = False
        shutil.rmtree(root, ignore_errors=True)
    split = ", ".join(f"{name} {t - t0:.1f}" for (name, t), (_n, t0) in
                      zip(marks, [("start", t_phase)] + marks[:-1]))
    print(f"cli phase: {time.perf_counter() - t_phase:.1f} s ({split})", flush=True)
    return launches


# the recurrent phase: the JAX bench's recurrent geometry
# (hcunet_tpu/benchmarks.py:429-476), full width, 10 timesteps
RECURRENT_SCENE = (256, 256, 10)
RECURRENT_BATCH = 4
RECURRENT_SPLIT = 4
RECURRENT_REPS = 3
# the convs of one RecursiveUNet timestep and one RDCNet iteration (and its
# output conv), in the order the serving forwards run them
RUNET_CONVS = (
    "down1.conv1", "down1.conv2",
    *(f"{b}_{g}.{c}" for g in ("fh", "fz") for b, c in (
        ("down2", "conv1"), ("down2", "conv2"), ("down3", "conv1"), ("down3", "conv2"),
        ("up1", "parity"), ("up1", "conv1"), ("up1", "conv2"))),
    "up2.parity", "up2.conv1", "up2.conv2", "out_conv",
)
RDCNET_CONVS = ("squeeze", *(f"dilation{d}" for d in range(1, 6)), "merge")
# float32 serving forward on K1 against the one on the plain conv, relative
# to the output's scale: K1's own float32 tolerance (``kernel_error``), held
# over the whole forward
RECURRENT_F32_TOL = 1e-5


def build_recurrent(model, gen):
    """``model`` (a RecursiveUNet or RDCNet) with He-normal conv weights (fan
    in as in the JAX package), zero biases and random, non-trivial batch-norm
    statistics and affine parameters, all from ``gen``; eval mode."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv3d, torch.nn.ConvTranspose3d)):
                w = m.weight
                cin = w.shape[0] if isinstance(m, torch.nn.ConvTranspose3d) else w.shape[1]
                fan_in = cin * math.prod(w.shape[2:])
                w.copy_(torch.randn(w.shape, generator=gen) * math.sqrt(2.0 / fan_in))
                m.bias.zero_()
            elif isinstance(m, torch.nn.BatchNorm3d):
                m.weight.copy_(torch.rand(m.weight.shape, generator=gen) + 0.5)
                m.bias.copy_(torch.randn(m.bias.shape, generator=gen) * 0.1)
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=gen) + 0.5)
    return model.eval()


def record_recurrent_convs(model, dev, names) -> tuple:
    """One bf16 serving forward of ``model`` at ``RECURRENT_SCENE`` with a
    recording plain conv (no kernel launch).  Returns the distinct convs
    ``(name, x shape (padded), w, b, relu, dilation, pad)`` in the order
    they first run, with ``names`` naming the convs of one step, and every
    call's label and record.  Every recurrent conv keeps its size, so its
    padding (what ``conv_same`` passes) is ``dilation * (k - 1) / 2``."""
    from hcunet_tpu_torch.infer.compile_recurrent import compile_recurrent_apply
    from hcunet_tpu_torch.ops.conv import conv3d_valid_plain

    calls = []

    def recording_conv(x, w, b, relu, dilation=1, padding=0):
        dil = (dilation,) * 3 if isinstance(dilation, int) else tuple(dilation)
        pad = (padding,) * 3 if isinstance(padding, int) else tuple(padding)
        padded = (x.shape[0], *(n + 2 * p for n, p in zip(x.shape[1:4], pad)), x.shape[4])
        calls.append((padded, w, b, relu, dil))
        return conv3d_valid_plain(x, w, b, relu, dilation, padding)

    apply = compile_recurrent_apply(model, dtype=torch.bfloat16, device=dev, conv=recording_conv)
    apply(torch.zeros((1, *RECURRENT_SCENE, model.config.in_channels), device=dev))
    per_step = len(names)
    extra = 1 if names is RDCNET_CONVS else 0  # RDCNet's output conv
    if len(calls) != per_step * model.config.timesteps + extra:
        raise AssertionError(f"recorded {len(calls)} convs, expected "
                             f"{per_step} x {model.config.timesteps} + {extra}")
    labels = [names[i % per_step] for i in range(len(calls) - extra)] + ["out_conv"] * extra
    seen, out = set(), []
    for label, (xs, w, b, relu, dil) in zip(labels, calls):
        key = (xs, tuple(w.shape), relu, dil)
        if key in seen:
            continue
        seen.add(key)
        pad = tuple(d * (k - 1) // 2 for d, k in zip(dil, w.shape[:3]))
        out.append((label, xs, w, b, relu, dil[0], pad))
    return out, labels, calls


def recurrent_k1_rows(family, model, dev, gen_dev, tag=None) -> list:
    """K1 against its plain version at each distinct conv of ``model``'s
    serving forward at ``RECURRENT_SCENE``, bf16 and float32, on the
    unpadded input with the padding as ``conv_same`` passes it, timed beside
    the plain version, cuDNN's ``F.conv3d`` with the same padding, the pad
    (0 on the basic path) and the bound; then the sums over one forward's
    launches.  ``tag`` (default ``family``) starts the rows' names."""
    names = RUNET_CONVS if family == "runet" else RDCNET_CONVS
    convs, labels, calls = record_recurrent_convs(model, dev, names)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        dt = "bf16" if dtype == torch.bfloat16 else "f32"
        print(f"{family}: K1 at the {len(convs)} distinct convs of a forward at "
              f"{RECURRENT_SCENE} vs plain, {dt}:", flush=True)
        by_key = {}
        for label, xs, w, b, relu, dil, pad in convs:
            core = [s - 2 * p for s, p in zip(xs[1:4], pad)]
            x = torch.randn((xs[0], *core, xs[4]), generator=gen_dev, device=dev).to(dtype)
            row = check_kernel(f"{tag or family}_{label}", x, w.to(dtype).contiguous(), b, relu,
                               dilation=dil, pad=pad)
            by_key[(xs, tuple(w.shape), relu, dil)] = row
            rows.append(row)
            del x
        # one forward's K1 launches at the shapes they run at
        fwd = [by_key[(xs, tuple(w.shape), relu, d[0])] for xs, w, _b, relu, d in calls]
        sums = {k: sum(r[k] for r in fwd) for k in ("ms", "bound_ms", "plain_ms",
                                                     "library_ms", "pad_ms")}
        ring = sum(1 for r in fwd if r["k1_route"] == "ring")
        print(f"K1 over one {family} {dt} forward ({len(fwd)} launches, {ring} ring): kernel "
              f"{sums['ms']:.3f} ms, bound {sums['bound_ms']:.3f} ms (kernel at "
              f"{100 * sums['bound_ms'] / sums['ms']:.1f}% of it), plain {sums['plain_ms']:.3f} "
              f"ms, cuDNN conv3d with the padding {sums['library_ms']:.3f} ms, the pads "
              f"{sums['pad_ms']:.3f} ms", flush=True)
        torch.cuda.empty_cache()
    return rows


def time_forward(apply, x, kernel, want_routes, label) -> tuple:
    """``RECURRENT_REPS`` forwards of ``apply`` on ``x`` after a warm-up,
    host clock around each (ending in a synchronize), the counts set to 0
    just before the first and read just after it.  Returns (output, mean
    seconds, K1 launches of one forward)."""
    out = apply(x)
    secs = []
    for i in range(RECURRENT_REPS):
        torch.cuda.synchronize()
        reset_counts([kernel])
        t0 = time.perf_counter()
        out = apply(x)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if i == 0:
            launches, routes = kernel.launches, dict(kernel.route_launches)
    mvx = math.prod(x.shape[:4]) / 1e6
    print(f"  {label}: {', '.join(f'{mvx / t:.2f}' for t in secs)} MVx/s "
          f"({', '.join(f'{1e3 * t:.1f}' for t in secs)} ms a forward of {list(x.shape)}); "
          f"K1 {launches} launches {routes} (expected {want_routes})", flush=True)
    if routes != want_routes:
        raise AssertionError(f"{label}: K1 launched {routes}, expected {want_routes}")
    if out.shape[:4] != x.shape[:4] or not torch.isfinite(out).all():
        raise AssertionError(f"{label}: bad output {tuple(out.shape)}")
    return out, sum(secs) / len(secs), launches


def profile_recurrent(label, fn) -> None:
    """One forward under ``torch.profiler``: the device's busy share, K1's
    share by path, and the device time under the pads
    (``aten::constant_pad_nd``), the interleaves and other copies
    (``aten::clone``), the joins and halo refreshes (``aten::cat``,
    ``aten::stack``), the pools and the gates; the idle rest is launch
    gaps and host work."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()

    def dev_us(ev, self_only):
        name = "self_device_time_total" if self_only else "device_time_total"
        us = getattr(ev, name, None)
        if us is None:
            us = getattr(ev, name.replace("device", "cuda"))
        return us

    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(dev_us(e, True) for e in kernels) / 1e3
    if busy == 0:
        print(f"profile of {label}: device time not measured (no device events)")
        return
    k1 = {name: sum(dev_us(e, True) for e in kernels if sym in e.key) / 1e3
          for name, sym in (("ring", "conv3d_valid_ring_kernel"),
                            ("basic", "conv3d_valid_kernel"))}
    ops = {}
    for op in ("aten::constant_pad_nd", "aten::clone", "aten::cat", "aten::stack",
               "aten::max_pool3d_with_indices", "aten::tanh", "aten::sigmoid", "aten::mul",
               "aten::add", "aten::zeros", "aten::ones"):
        ops[op] = sum(dev_us(e, False) for e in events if e.key == op) / 1e3
    print(f"profile of {label}: wall {wall:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / wall:.1f}%, idle {100 * (1 - busy / wall):.1f}%: launch gaps and "
          f"host work), K1 ring {k1['ring']:.2f} ms + basic {k1['basic']:.2f} ms "
          f"({100 * sum(k1.values()) / busy:.1f}% of device time); by op: "
          + ", ".join(f"{op[6:]} {ms:.2f} ms" for op, ms in ops.items()), flush=True)
    for e in sorted(kernels, key=lambda e: -dev_us(e, True))[:8]:
        print(f"  {dev_us(e, True) / 1e3:9.2f} ms {e.count:5d}x  {e.key[:110]}")


def write_recurrent_stack(path, seed) -> np.ndarray:
    """A uint16 stack of ``RECURRENT_SCENE`` in the on-disk layout [Z, Y, X,
    C] at ``path``; returns it normalized as ``predict-recurrent`` reads it,
    [X, Y, Z, C] float32 in [-1, 1]."""
    from hcunet_tpu_torch.data.transforms import integer_unit_scale

    vol = np.random.default_rng(seed).integers(0, 65535, (*RECURRENT_SCENE, 4), dtype=np.uint16)
    np.save(path, np.ascontiguousarray(vol.transpose(2, 1, 0, 3)))
    return ((vol.astype(np.float32) / integer_unit_scale(vol.dtype) - 0.5) / 0.5).astype(
        np.float32)


def recurrent_phase(dev, kernel) -> tuple:
    """The recurrent family's serving on the card at full width: a
    ``RecursiveUNet`` (``RUNetConfig()``: 16/32/64, 10 timesteps) and an
    ``RDCNet`` (``RDCNetConfig()``: complexity 10, 10 iterations), random
    weights from the seed.  K1 at every distinct conv of both serving
    forwards (bf16 and float32); the JAX bench geometry (B=1 at
    ``RECURRENT_SCENE`` with ``split_x`` 1 and 4, and a batch of 4 for the
    RecursiveUNet) in bf16, timed, with K1's launches per forward (RUNet 200,
    190 ring; RDCNet 71, all basic); at float32 each split equal to its
    unsplit forward and the K1 forward within ``RECURRENT_F32_TOL`` of the
    scale of one on the plain conv; in bf16 the serving forward within 4 % of
    the scale of the model's own eval forward (bf16 and float32);
    ``predict-recurrent`` through ``cli.main`` on two ``.npy`` stacks from a
    checkpoint the port wrote, and again with ``--split-x 4``, equal to
    ``compile_recurrent_apply``; and one RUNet forward under the profiler.
    Returns the K1 rows and the K1 launches of the path (the timed forwards'
    first runs and the command's)."""
    from hcunet_tpu_torch.config import RDCNetConfig, RUNetConfig
    from hcunet_tpu_torch.infer.compile_recurrent import compile_recurrent_apply
    from hcunet_tpu_torch.models.rdcnet import RDCNet
    from hcunet_tpu_torch.models.runet import RecursiveUNet
    from hcunet_tpu_torch.ops.conv import conv3d_valid_plain
    from hcunet_tpu_torch.utils.checkpoint import save_checkpoint
    from hcunet_tpu_torch.utils.port_jax import jax_variables_from_runet_state_dict

    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED)
    gen_dev = torch.Generator(device=dev).manual_seed(SEED)
    models = {
        "runet": build_recurrent(RecursiveUNet(RUNetConfig()), gen).to(dev),
        "rdcnet": build_recurrent(RDCNet(RDCNetConfig()), gen).to(dev),
    }
    rows, launches = [], 0
    x1 = torch.randn((1, *RECURRENT_SCENE, 4), generator=gen_dev, device=dev)
    for family, model in models.items():
        rows += recurrent_k1_rows(family, model, dev, gen_dev)
        n = model.config.timesteps
        per = {"basic": n, "ring": 19 * n} if family == "runet" else {"basic": 7 * n + 1,
                                                                      "ring": 0}
        print(f"{family} serving, bf16, {RECURRENT_SCENE}, host clock:", flush=True)
        out, base_s, k = time_forward(compile_recurrent_apply(model, device=dev), x1, kernel,
                                      per, "B=1, split_x=1")
        launches += k
        split = compile_recurrent_apply(model, device=dev, split_x=RECURRENT_SPLIT)
        _o, split_s, k = time_forward(split, x1, kernel, per, f"B=1, split_x={RECURRENT_SPLIT}")
        launches += k
        if family == "runet":
            xb = torch.randn((RECURRENT_BATCH, *RECURRENT_SCENE, 4), generator=gen_dev,
                             device=dev)
            _o, batch_s, k = time_forward(compile_recurrent_apply(model, device=dev), xb,
                                          kernel, per, f"B={RECURRENT_BATCH}")
            launches += k
            del xb, _o

        # bf16 against the model's own eval forward, bf16 and float32
        with torch.no_grad():
            model32 = model(x1).float()
            m16 = type(model)(model.config, dtype=torch.bfloat16)
            m16.load_state_dict(model.state_dict())
            model16 = m16.to(dev).eval()(x1).float()
        scale = float(model32.abs().max())
        g16 = float((out - model16).abs().max()) / float(model16.abs().max())
        g32 = float((out - model32).abs().max()) / scale
        d16 = float((model16 - model32).abs().max()) / scale
        print(f"  bf16 serving vs the model's float32 eval forward: {g32:.4f} of the scale "
              f"(limit 0.04; output scale {scale:.3f}); vs its bf16 eval forward {g16:.4f}, "
              f"which is itself {d16:.4f} from the float32 one", flush=True)
        if not g32 <= 0.04:
            raise AssertionError(f"{family}: bf16 serving {g32:.4f} of the scale off the model")
        del m16, model16

        # float32: split equal to unsplit, K1 against the plain conv.  RDCNet's
        # transposed conv is cuDNN's dgrad, whose default algorithms sum in
        # an order that changes from run to run: the split is held with
        # cuDNN deterministic, and the unsplit forward's own run-to-run gap
        # without it is printed beside
        f32_apply = compile_recurrent_apply(model, dtype=torch.float32, device=dev)
        rerun_d = float((f32_apply(x1) - f32_apply(x1)).abs().max())
        torch.backends.cudnn.deterministic = True
        try:
            f32 = f32_apply(x1)
            f32_split = compile_recurrent_apply(model, dtype=torch.float32, device=dev,
                                                split_x=RECURRENT_SPLIT)(x1)
        finally:
            torch.backends.cudnn.deterministic = False
        f32_plain = compile_recurrent_apply(model, dtype=torch.float32, device=dev,
                                            conv=conv3d_valid_plain)(x1)
        split_d = float((f32_split - f32).abs().max())
        plain_d = float((f32 - f32_plain).abs().max()) / float(f32_plain.abs().max())
        print(f"  float32: split_x={RECURRENT_SPLIT} vs unsplit max |d| {split_d:.3e} "
              f"(must be 0; cuDNN deterministic; the unsplit forward run twice without it: "
              f"{rerun_d:.3e}); K1 vs the plain conv {plain_d:.3e} of the scale (tolerance "
              f"{RECURRENT_F32_TOL}); K1 vs the model's float32 forward "
              f"{float((f32 - model32).abs().max()) / scale:.3e}", flush=True)
        if split_d != 0.0 or not plain_d <= RECURRENT_F32_TOL:
            raise AssertionError(f"{family}: float32 split {split_d}, K1 vs plain {plain_d}")
        vox = math.prod(RECURRENT_SCENE) / 1e6
        print(f"{family} serving summary (bf16): B=1 {vox / base_s:.2f} MVx/s, split_x="
              f"{RECURRENT_SPLIT} {vox / split_s:.2f} MVx/s"
              + (f", B={RECURRENT_BATCH} {RECURRENT_BATCH * vox / batch_s:.2f} MVx/s"
                 if family == "runet" else ""), flush=True)
        del out, f32, f32_split, f32_plain, model32
        torch.cuda.empty_cache()

    # predict-recurrent through the command line, on a checkpoint the port wrote
    runet = models["runet"]
    root = tempfile.mkdtemp(prefix="chip_smoke_recurrent_")
    try:
        ckpt = os.path.join(root, "runet.hcunet")
        save_checkpoint(ckpt, jax_variables_from_runet_state_dict(runet.state_dict()),
                        runet.config, snapshot_sources=False)
        paths = [os.path.join(root, f"r{i}.npy") for i in range(2)]
        vols = [write_recurrent_stack(p, SEED + i) for i, p in enumerate(paths)]
        batch = torch.from_numpy(np.stack(vols)).to(dev)
        for flags, split_x in (([], 1), (["--split-x", str(RECURRENT_SPLIT)], RECURRENT_SPLIT)):
            out_dir = os.path.join(root, f"out{split_x}")
            torch.cuda.synchronize()
            reset_counts([kernel])
            t0 = time.perf_counter()
            info = cli_main(["predict-recurrent", *paths, "--checkpoint", ckpt,
                             "--out-dir", out_dir, *flags])
            sec = time.perf_counter() - t0
            cli_launches, cli_routes = kernel.launches, dict(kernel.route_launches)
            launches += cli_launches
            apply = compile_recurrent_apply(runet, device=dev, split_x=split_x)
            if split_x == 1:
                want = apply(batch).cpu().numpy()
            else:
                want = np.stack([apply(batch[i:i + 1])[0].cpu().numpy() for i in range(2)])
            same = all(np.array_equal(np.load(info["outputs"][p]), want[i])
                       for i, p in enumerate(paths))
            print(f"predict-recurrent {' '.join(flags) or '(batched)'} on 2 stacks "
                  f"{RECURRENT_SCENE}: {sec:.3f} s, K1 {cli_launches} launches {cli_routes}, "
                  f"outputs equal to compile_recurrent_apply's: {same}", flush=True)
            # one batched forward, or one forward per volume under --split-x
            want_n = 20 * runet.config.timesteps * (1 if split_x == 1 else len(paths))
            if not same or cli_launches != want_n:
                raise AssertionError(f"predict-recurrent {flags}: equal {same}, "
                                     f"{cli_launches} K1 launches")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    apply = compile_recurrent_apply(runet, device=dev)
    profile_recurrent(f"one RecursiveUNet bf16 forward {list(x1.shape)}", lambda: apply(x1))
    print(f"recurrent phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return rows, launches


# the recurrent training phase: train-recurrent's default --crop and --lr
RTRAIN_CROP = (128, 128, 10)
# the stacks train-recurrent reads: larger than its crop, so that the
# recipe's nul_crop (which drops rows and columns without a cell) leaves it
# room
RTRAIN_STACK = (160, 160, 10)
RTRAIN_STEPS = 20
RTRAIN_LR = 1e-3
# the trained gate of tests/test_recurrent_trained_gate.py on its scene,
# at twice its 150 Adam steps (at 150 the vector field can still merge
# cells; PERF.md), a cell matched at IoU >= GATE_IOU
GATE_SCENE = (64, 64, 8)
GATE_STEPS = 300
GATE_IOU = 0.5


def recurrent_scene(shape, seed) -> dict:
    """A RecursiveStack sample of ``shape`` [X, Y, Z]: blob cells on a
    jittered grid of pitch 10 (rows of cells, as hair cells sit; every row
    and column of the plane meets one), each a color in an instance mask,
    and the targets the port's
    ``train/targets.py`` builds from it (the pwl map, the center map and the
    pixel-to-center vectors), as ``preprocess`` builds them.  Returns the
    on-disk arrays ([Z, Y, X, ...]: ``image`` uint16, ``mask`` uint8 0/255,
    ``pwl``, ``com`` uint16, ``vec``) and the training batch
    ``(image, mask, pwl, com, vec)`` [1, X, Y, Z, C], normalized as the
    command line's recipe leaves it."""
    from hcunet_tpu_torch.train.targets import center_of_mass_target, make_pwl, vector_to_center

    X, Y, Z = shape
    rng = np.random.default_rng(seed)
    xx, yy, zz = np.meshgrid(np.arange(X), np.arange(Y), np.arange(Z), indexing="ij")
    labels = np.zeros(shape, np.int32)
    best = np.full(shape, np.inf)
    grid = [(gx, gy) for gx in range(6, X - 4, 10) for gy in range(6, Y - 4, 10)]
    for i, (gx, gy) in enumerate(grid):
        c = (gx + rng.uniform(-1.5, 1.5), gy + rng.uniform(-1.5, 1.5), rng.uniform(1, Z - 1))
        r = rng.uniform(5.5, 7.5)
        d2 = (xx - c[0]) ** 2 + (yy - c[1]) ** 2 + ((zz - c[2]) * 2.5) ** 2
        hit = (d2 < r * r) & (d2 < best)
        labels[hit] = i + 1
        best = np.where(hit, d2, best)
    zyx = labels.transpose(2, 1, 0)
    color = np.zeros((*zyx.shape, 3), np.uint8)  # background black, one color a cell
    for i in range(1, len(grid) + 1):
        color[zyx == i] = (i % 251 + 1, i // 251 + 1, (7 * i) % 253 + 1)
    pwl = make_pwl(color).astype(np.float32)
    centers, cell_labels = center_of_mass_target(color)
    vec = vector_to_center(centers, cell_labels).astype(np.float32)
    glow = np.exp(-np.minimum(best, 400.0) / (2 * 6.0**2))
    img = np.stack([np.clip(glow * s + rng.normal(0, 0.02, shape), 0, 1)
                    for s in (0.9, 1.0, 0.95, 0.9)], axis=-1).astype(np.float32)
    mask = (labels > 0).astype(np.float32)
    batch = (
        ((img - 0.5) / 0.5)[None],
        mask[None, ..., None],
        pwl.transpose(2, 1, 0)[None, ..., None],
        centers.transpose(2, 1, 0).astype(np.float32)[None, ..., None],
        vec.transpose(2, 1, 0, 3)[None],
    )
    disk = {
        "image": np.ascontiguousarray((img * 65535).astype(np.uint16).transpose(2, 1, 0, 3)),
        "mask": np.ascontiguousarray(np.where(zyx > 0, 255, 0).astype(np.uint8)),
        "pwl": pwl,
        "com": centers.astype(np.uint16),
        "vec": vec,
    }
    return {"batch": batch, "disk": disk, "labels": labels}


def write_recursive_stack(root, name, scene) -> None:
    """``scene``'s on-disk arrays as a RecursiveStack sample: ``<name>.npy``,
    ``.mask.npy``, ``.pwl.npy``, ``.labels.com.tif`` and
    ``.labels.vector.pkl``."""
    import pickle

    from hcunet_tpu_torch.data.tiff import imwrite

    disk = scene["disk"]
    stem = os.path.join(root, name)
    np.save(f"{stem}.npy", disk["image"])
    np.save(f"{stem}.mask.npy", disk["mask"])
    np.save(f"{stem}.pwl.npy", disk["pwl"])
    imwrite(f"{stem}.labels.com.tif", disk["com"])
    with open(f"{stem}.labels.vector.pkl", "wb") as f:
        pickle.dump(disk["vec"], f)


def recurrent_model(family, dtype=torch.float32, seed=SEED):
    """``RUNetConfig()`` or ``RDCNetConfig()`` at full width with the JAX
    initializers' distributions (truncated He-normal kernels, zero biases)
    drawn from ``seed``, as ``train-recurrent`` starts it."""
    from hcunet_tpu_torch.config import RDCNetConfig, RUNetConfig
    from hcunet_tpu_torch.models.rdcnet import RDCNet
    from hcunet_tpu_torch.models.runet import RecursiveUNet
    from hcunet_tpu_torch.models.unet import init_like_flax

    model = RecursiveUNet(RUNetConfig()) if family == "runet" else RDCNet(RDCNetConfig())
    init_like_flax(model, torch.Generator().manual_seed(seed))
    model.dtype = dtype
    return model


def rtrain_step_launches(family, timesteps, dtype) -> tuple:
    """K1's launches by path in one training step: the forward's, and the
    input gradients'.  A RecursiveUNet timestep runs 17 same-padding convs
    (its transposed convs are cuDNN's), 16 of them on the ring path in bf16
    (all but the 9-channel first conv); their input gradients take the ring
    path where Cout % 8 == 0 (all but out_conv's, Cout 5), and the first
    conv of timestep 0 needs none (the image and the zero state).  An RDCNet
    iteration runs 7 (the squeeze, 5 dilations, the merge) and its output
    conv one more, all Cout 10: the basic path, forward and backward."""
    bf16 = dtype == torch.bfloat16
    T = timesteps
    if family == "runet":
        ring = 16 * T if bf16 else 0
        ring_g = 16 * T - 1 if bf16 else 0
        return ({"basic": 17 * T - ring, "ring": ring},
                {"basic": 17 * T - 1 - ring_g, "ring": ring_g})
    n = 7 * T + 1
    return {"basic": n, "ring": 0}, {"basic": n, "ring": 0}


def rtrain_trainer(model, dev, lr=RTRAIN_LR):
    from hcunet_tpu_torch.train.trainer import RecurrentTrainer, TrainConfig

    return RecurrentTrainer(model, cfg=TrainConfig(learning_rate=lr, log_every=0), device=dev)


def rtrain_fit(family, dtype, batch, dev, kernels) -> dict:
    """``RTRAIN_STEPS`` steps of ``RecurrentTrainer`` on ``batch``, each
    checked for its K1 launches by path; the loss must fall."""
    model = recurrent_model(family, dtype)
    trainer = rtrain_trainer(model, dev)
    tensors = [torch.from_numpy(a).to(dev) for a in batch]
    fwd_want, grad_want = rtrain_step_launches(family, model.config.timesteps, dtype)
    fwd_k, grad_k = kernels
    losses, secs = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for step in range(RTRAIN_STEPS):
        fwd0, grad0 = dict(fwd_k.route_launches), dict(grad_k.route_launches)
        t0 = time.perf_counter()
        losses.append(trainer.train_step(tensors[0], tensors[1], tensors[2], tensors[4]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        fwd = {r: n - fwd0[r] for r, n in fwd_k.route_launches.items()}
        grad = {r: n - grad0[r] for r, n in grad_k.route_launches.items()}
        if fwd != fwd_want or grad != grad_want:
            raise AssertionError(f"{family} {dtype} step {step}: K1 forward {fwd} (expected "
                                 f"{fwd_want}), input gradient {grad} (expected {grad_want})")
    peak = torch.cuda.max_memory_allocated()
    step_ms = float(np.median(secs[1:])) * 1e3
    dt = "bf16" if dtype == torch.bfloat16 else "f32"
    print(f"rtrain fit {family} {dt} ({model.config}), input {list(batch[0].shape)}, "
          f"{RTRAIN_STEPS} Adam({RTRAIN_LR}) steps: loss {losses[0]:.6f} -> {losses[-1]:.6f}; "
          f"{step_ms:.3f} ms a step (median of steps 2-{RTRAIN_STEPS}; step 1 "
          f"{secs[0] * 1e3:.1f} ms); peak device memory {peak / 2**30:.2f} GiB; K1 a step: "
          f"forward {fwd_want}, input gradient {grad_want}", flush=True)
    if not losses[-1] < losses[0] or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{family} {dt}: the loss did not fall: {losses[0]} -> {losses[-1]}")
    return {"step_ms": step_ms, "peak": peak, "losses": losses}


def rtrain_parity(family, dtype, batch, dev, kernels) -> None:
    """3 ``RecurrentTrainer`` steps with K1 against 3 on the plain conv from
    the same weights, held by ``trajectory_gap`` to the gaps of
    ``N_JITTER`` jittered plain runs (``train/parity.py``'s rule, the U-Net
    ``train`` phase's)."""
    fwd_k, grad_k = kernels
    sd0 = recurrent_model(family, seed=SEED + 1).state_dict()
    start = rtrain_trainer(recurrent_model(family, seed=SEED + 1), "cpu").variables
    tensors = [torch.from_numpy(a).to(dev) for a in batch]
    fwd_want, grad_want = rtrain_step_launches(family, 10, dtype)
    runs = {"kernel": contextlib.nullcontext(), "plain": plain_conv()}
    runs.update({f"jittered{i}": plain_conv(torch.Generator(device=dev).manual_seed(SEED + i))
                 for i in range(N_JITTER)})
    for label, ctx in runs.items():
        model = recurrent_model(family, dtype)
        model.load_state_dict(sd0)
        trainer = rtrain_trainer(model, dev)
        before = (fwd_k.launches, grad_k.launches)
        with ctx:
            losses = [trainer.train_step(tensors[0], tensors[1], tensors[2], tensors[4])]
            grads = trainer._jax_from_state_dict(
                {n: p.grad for n, p in model.named_parameters()})["params"]
            losses += [trainer.train_step(tensors[0], tensors[1], tensors[2], tensors[4])
                       for _ in range(PARITY_STEPS - 1)]
        launched = (fwd_k.launches - before[0], grad_k.launches - before[1])
        want = ((sum(fwd_want.values()) * PARITY_STEPS, sum(grad_want.values()) * PARITY_STEPS)
                if label == "kernel" else (0, 0))
        if launched != want:
            raise AssertionError(f"{family} {label} run launched K1 {launched}, expected {want}")
        runs[label] = (trainer.variables, losses, grads)
        del trainer, model
        torch.cuda.empty_cache()
    jittered = [runs[f"jittered{i}"] for i in range(N_JITTER)]
    line = trajectory_gap(runs["kernel"], runs["plain"], jittered, start, dtype, lr=RTRAIN_LR)
    print(f"rtrain parity {family}, {dtype}, {PARITY_STEPS} steps, K1 vs the plain conv: losses "
          + " vs ".join(str([round(v, 6) for v in r[1]]) for r in runs.values())
          + f" ({', '.join(runs)}); {line}", flush=True)


def rtrain_grad_shapes(family, batch, dev) -> tuple:
    """The input-gradient calls of one bf16 training step of ``family`` on
    ``batch``: ``{(gy shape, w shape, dilation, padding): [w, calls]}`` and
    the number of calls."""
    records = []
    model = recurrent_model(family, torch.bfloat16)
    trainer = rtrain_trainer(model, dev)
    tensors = [torch.from_numpy(a).to(dev) for a in batch]
    with recording_input_grad(records):
        trainer.train_step(tensors[0], tensors[1], tensors[2], tensors[4])
    del trainer, model
    shapes = {}
    for gy_shape, w, dil, padding in records:
        d = dil if isinstance(dil, int) else dil[0]
        # conv_same's symmetric padding, as Conv3dValidFunction carries it
        pad = tuple(lo for lo, _hi in padding)
        key = (gy_shape, tuple(w.shape), d, pad)
        if key not in shapes:
            shapes[key] = [w, 0]
        shapes[key][1] += 1
    return shapes, len(records)


def rtrain_input_grad_rows(family, batch, dev, step_ms) -> list:
    """K1's input gradient at every distinct shape one training step of
    ``family`` gives it (recorded from a bf16 step), against its plain
    version in bf16 and float32, timed beside cuDNN's dgrad of the padded
    conv and the bound of the unpadded input; then the sums over one step's
    calls beside ``step_ms`` (``{dtype name: ms a step}``)."""
    shapes, n_calls = rtrain_grad_shapes(family, batch, dev)
    gen_dev = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        dt = "bf16" if dtype == torch.bfloat16 else "f32"
        print(f"{family}: K1 input gradient at the {len(shapes)} distinct shapes of a training "
              f"step ({n_calls} calls) vs plain, {dt}:", flush=True)
        sums = dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms", "pad_ms"), 0.0)
        for (gy_shape, w_shape, d, pad), (w, count) in shapes.items():
            k = w_shape[0]
            name = f"{family} k{k} d{d} {w_shape[3]}->{w_shape[4]}"
            gy = torch.randn(gy_shape, generator=gen_dev, device=dev).to(dtype)
            row = check_input_grad(name, gy, w.to(dtype).contiguous(), d, pad)
            row["calls_per_step"] = count
            rows.append(row)
            for key in sums:
                sums[key] += count * row[key]
            del gy
        torch.cuda.empty_cache()
        print(f"{family} K1 input gradient {dt}, one training step ({n_calls} calls): "
              f"kernel {sums['ms']:.3f} ms ({100 * sums['ms'] / step_ms[dt]:.1f}% of the "
              f"{step_ms[dt]:.3f} ms step), cuDNN dgrad {sums['library_ms']:.3f} ms "
              f"(kernel/cuDNN {sums['ms'] / sums['library_ms']:.3f}), plain "
              f"{sums['plain_ms']:.3f} ms, bound {sums['bound_ms']:.3f} ms (kernel at "
              f"{100 * sums['bound_ms'] / sums['ms']:.1f}% of it); the ring path's pads of gy "
              f"{sums['pad_ms']:.3f} ms (besides the kernel time; 0 on the basic path)", flush=True)
    return rows


@contextlib.contextmanager
def tf32(at_defaults: bool):
    """TF32 at torch's defaults (``TORCH_TF32_DEFAULTS``) or off, for the
    block; off again after it."""
    cudnn, matmul = TORCH_TF32_DEFAULTS if at_defaults else (False, False)
    torch.backends.cudnn.allow_tf32 = cudnn
    torch.backends.cuda.matmul.allow_tf32 = matmul
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def rtrain_tf32(batch, dev) -> None:
    """Fault F4 for ``train-recurrent``: the float32 losses of the first two
    steps (the second after one step's cuDNN wgrad) with TF32 at torch's
    defaults against TF32 off, from the same weights."""
    tensors = [torch.from_numpy(a).to(dev) for a in batch]
    for family in ("runet", "rdcnet"):
        got = {}
        for label, on in (("off", False), ("defaults", True)):
            trainer = rtrain_trainer(recurrent_model(family), dev)
            with tf32(on):
                got[label] = [trainer.train_step(tensors[0], tensors[1], tensors[2], tensors[4])
                              for _ in range(2)]
            del trainer
        rel = [abs(a - b) / abs(b) for a, b in zip(got["defaults"], got["off"])]
        print(f"F4 train-recurrent {family} float32: losses of steps 1-2 with TF32 off "
              f"{got['off']}, at torch's defaults {got['defaults']}: relative gaps "
              f"{[f'{r:.3e}' for r in rel]}", flush=True)


def gate_scene():
    """The scene of ``tests/test_recurrent_trained_gate.py::_scene`` (4
    cells in 64 x 64 x 8, seed 0): image, mask, pwl, vector [1, X, Y, Z, C]
    and the true labels [X, Y, Z]."""
    X, Y, Z = GATE_SCENE
    rng = np.random.default_rng(0)
    centers = [(14, 14, 4), (14, 46, 4), (44, 22, 4), (46, 48, 4)]
    xx, yy, zz = np.meshgrid(np.arange(X), np.arange(Y), np.arange(Z), indexing="ij")
    labels = np.zeros((X, Y, Z), np.int32)
    best = np.full((X, Y, Z), np.inf)
    for i, (cx, cy, cz) in enumerate(centers):
        d2 = (xx - cx) ** 2 + (yy - cy) ** 2 + ((zz - cz) * 2.5) ** 2
        hit = (d2 < 8.5**2) & (d2 < best)
        labels[hit] = i + 1
        best = np.where(hit, d2, best)
    mask = (labels > 0).astype(np.float32)
    vector = np.zeros((X, Y, Z, 3), np.float32)
    for i, (cx, cy, cz) in enumerate(centers):
        m = labels == i + 1
        vector[m, 0] = (zz[m] - cz) / Z
        vector[m, 1] = (yy[m] - cy) / Y
        vector[m, 2] = (xx[m] - cx) / X
    intensity = np.exp(-best / (2 * 6.0**2)).astype(np.float32)
    img = np.stack([np.clip(intensity * s + rng.normal(0, 0.02, (X, Y, Z)), 0, 1)
                    for s in (0.9, 1.0, 0.95, 0.9)], axis=-1).astype(np.float32)
    img = (img - 0.5) / 0.5
    return (img[None], mask[None, ..., None], np.ones((1, X, Y, Z, 1), np.float32),
            vector[None], labels)


def match_instances(a, b) -> list:
    """Greedy 1:1 IoU matching of the instance labels of ``a`` to those of
    ``b`` (``tests/test_recurrent_trained_gate.py::_match_instances``):
    ``[(id_a, id_b, iou)]``."""
    ids_b = [i for i in np.unique(b) if i > 0]
    pairs, used = [], set()
    for ia in (i for i in np.unique(a) if i > 0):
        ma = a == ia
        best = (None, 0.0)
        for ib in ids_b:
            if ib in used:
                continue
            mb = b == ib
            iou = float((ma & mb).sum() / max((ma | mb).sum(), 1))
            if iou > best[1]:
                best = (ib, iou)
        if best[0] is not None:
            used.add(best[0])
            pairs.append((int(ia), int(best[0]), best[1]))
    return pairs


def trained_gate(dev) -> None:
    """``tests/test_recurrent_trained_gate.py`` composed on the card: RDCNet
    (``RDCNetConfig()``, torch's default init from seed 0, the reference
    model's, as the JAX test starts) trained by ``RecurrentTrainer`` (Adam 1e-3, pixel
    BCE + MSE) for ``GATE_STEPS`` steps on the gate scene, served by
    ``compile_recurrent_apply`` in float32, clustered by
    ``pixel_vec_to_cell`` (the vectors de-normalized and negated, as the
    JAX test does); its instances matched 1:1 to the scene's cells by IoU
    (the JAX test's greedy matching): at least half the cells must match at
    IoU >= ``GATE_IOU``."""
    from hcunet_tpu_torch.infer.compile_recurrent import compile_recurrent_apply
    from hcunet_tpu_torch.infer.vector_cluster import pixel_vec_to_cell

    from hcunet_tpu_torch.config import RDCNetConfig
    from hcunet_tpu_torch.models.rdcnet import RDCNet

    img, mask, pwl, vector, true_labels = gate_scene()
    # the JAX test starts from the torch reference RDCNet's weights (torch's
    # default conv init after torch.manual_seed(0)): so does this one
    torch.manual_seed(0)
    model = RDCNet(RDCNetConfig())
    trainer = rtrain_trainer(model, dev)
    t = [torch.from_numpy(a).to(dev) for a in (img, mask, pwl, vector)]
    t0 = time.perf_counter()
    losses = [trainer.train_step(*t) for _ in range(GATE_STEPS)]
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    apply = compile_recurrent_apply(model.eval(), dtype=torch.float32, device=dev)
    out = apply(torch.from_numpy(img).to(dev))[0].cpu().numpy()
    prob = 1.0 / (1.0 + np.exp(-out[..., 0]))
    X, Y, Z = GATE_SCENE
    labels = pixel_vec_to_cell(out[..., 2:] * np.asarray([-Z, -Y, -X], np.float32), prob)
    pairs = match_instances(true_labels, labels)
    matched = sum(1 for p in pairs if p[2] >= GATE_IOU)
    n_true = len([i for i in np.unique(true_labels) if i > 0])
    sem, truth = prob > 0.5, true_labels > 0
    dice = 2 * (sem & truth).sum() / max(sem.sum() + truth.sum(), 1)
    print(f"trained gate: RDCNet, {GATE_STEPS} steps (the JAX test takes 150) on {GATE_SCENE} in "
          f"{fit_s:.1f} s, loss {losses[0]:.4f} -> {losses[-1]:.4f}; dice {dice:.3f}; "
          f"{len([i for i in np.unique(labels) if i > 0])} instances, {matched} of {n_true} "
          f"cells matched at IoU >= {GATE_IOU} (pair IoUs {[round(p[2], 3) for p in pairs]})",
          flush=True)
    if 2 * matched < n_true:
        raise AssertionError(f"trained gate: {matched} of {n_true} cells matched")


def rtrain_cli(dev) -> None:
    """``train-recurrent --model rdcnet --epochs 1`` through ``cli.main`` on
    two stacks of ``RTRAIN_STACK`` written to a temporary directory, and the
    checkpoint it writes served by ``predict-recurrent``, equal to
    ``compile_recurrent_apply`` on the loaded model (cuDNN deterministic:
    RDCNet's transposed conv varies run to run otherwise)."""
    from hcunet_tpu_torch.data.transforms import integer_unit_scale
    from hcunet_tpu_torch.infer.compile_recurrent import compile_recurrent_apply
    from hcunet_tpu_torch.utils.checkpoint import load_model

    root = tempfile.mkdtemp(prefix="chip_smoke_rtrain_")
    try:
        stack = os.path.join(root, "stack")
        os.makedirs(stack)
        scenes = [recurrent_scene(RTRAIN_STACK, SEED + 10 + i) for i in range(2)]
        for i, scene in enumerate(scenes):
            write_recursive_stack(stack, f"r{i}", scene)
        ckpt = os.path.join(root, "rdcnet.hcunet")
        t0 = time.perf_counter()
        info = cli_main(["train-recurrent", stack, "--model", "rdcnet", "--epochs", "1",
                         "--out", ckpt])
        train_s = time.perf_counter() - t0
        if info != {"checkpoint": ckpt, "model": "rdcnet"}:
            raise AssertionError(f"train-recurrent printed {info}")
        img_path = os.path.join(stack, "r0.npy")
        torch.backends.cudnn.deterministic = True
        try:
            pred = cli_main(["predict-recurrent", img_path, "--checkpoint", ckpt,
                             "--out-dir", os.path.join(root, "out")])
            got = np.load(pred["outputs"][img_path])
            model, _v, _h = load_model(ckpt, device=dev)
            vol = scenes[0]["disk"]["image"].transpose(2, 1, 0, 3)
            x = (vol.astype(np.float32) / integer_unit_scale(vol.dtype) - 0.5) / 0.5
            want = compile_recurrent_apply(model, device=dev)(
                torch.from_numpy(x[None]).to(dev))[0].cpu().numpy()
        finally:
            torch.backends.cudnn.deterministic = False
        same = bool(np.array_equal(got, want))
        print(f"cli train-recurrent --model rdcnet --epochs 1 (2 stacks {RTRAIN_STACK}, crop "
              f"{RTRAIN_CROP}): "
              f"{train_s:.2f} s, {info}; predict-recurrent on it: {got.shape}, finite "
              f"{bool(np.isfinite(got).all())}, equal to compile_recurrent_apply: {same}",
              flush=True)
        if not same or got.shape != (*RTRAIN_STACK, 5) or not np.isfinite(got).all():
            raise AssertionError("predict-recurrent on the trained checkpoint")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def rtrain_phase(dev, kernels) -> tuple:
    """Training of the recurrent family on the card at full width:
    ``RecurrentTrainer`` on ``RUNetConfig()`` and ``RDCNetConfig()`` (10
    timesteps) in float32 and bf16 on a synthetic ``RTRAIN_CROP`` sample
    (the path: the counts set to 0 before these four fits and read after),
    ms a step and the peak memory, each step's K1 launches by path, the loss
    falling over ``RTRAIN_STEPS`` steps; 3 K1 steps against 3 on the plain
    conv within the jittered runs' gaps; K1's input gradient at every
    recurrent training shape against its plain version; F4's TF32 gap of
    the first losses; the trained gate; ``train-recurrent`` and
    ``predict-recurrent`` through ``cli.main``.  ``kernels``: K1's forward
    and input-gradient counts.  Returns the input-gradient rows and the
    path's K1 launches ``{"forward", "input_grad"}``."""
    fwd_k, grad_k = kernels
    t_phase = time.perf_counter()
    marks = []
    batch = recurrent_scene(RTRAIN_CROP, SEED)["batch"]
    marks.append(("scene", time.perf_counter()))
    torch.cuda.synchronize()
    reset_counts([fwd_k, grad_k])
    fits = {}
    for family in ("runet", "rdcnet"):
        for dtype in (torch.float32, torch.bfloat16):
            fits[family, dtype] = rtrain_fit(family, dtype, batch, dev, kernels)
            torch.cuda.empty_cache()
    launches = {"forward": fwd_k.launches, "input_grad": grad_k.launches}
    want = {"forward": 0, "input_grad": 0}
    for family in ("runet", "rdcnet"):
        for dtype in (torch.float32, torch.bfloat16):
            f, g = rtrain_step_launches(family, 10, dtype)
            want["forward"] += RTRAIN_STEPS * sum(f.values())
            want["input_grad"] += RTRAIN_STEPS * sum(g.values())
    print(f"rtrain path: K1 forward {launches['forward']} ({fwd_k.route_launches}), input "
          f"gradient {launches['input_grad']} ({grad_k.route_launches}) over the four fits",
          flush=True)
    if launches != want:
        raise AssertionError(f"the rtrain fits launched K1 {launches}, expected {want}")
    marks.append(("fits", time.perf_counter()))
    tensors = [torch.from_numpy(a).to(dev) for a in batch]
    for family, dtype in (("runet", torch.float32), ("runet", torch.bfloat16)):
        trainer = rtrain_trainer(recurrent_model(family, dtype), dev)

        def step():
            return trainer.train_step(tensors[0], tensors[1], tensors[2], tensors[4])

        step()  # warm-up
        profile_device(f"one {family} {dtype} training step {list(batch[0].shape)}", step,
                       {"K1": "conv3d_valid", "cuDNN wgrad": "wgrad", "cuDNN dgrad": "dgrad",
                        "batch norm": "batch_norm", "Adam": "adam"})
        del trainer
    torch.cuda.empty_cache()
    marks.append(("profiles", time.perf_counter()))
    for family in ("runet", "rdcnet"):
        for dtype in (torch.float32, torch.bfloat16):
            rtrain_parity(family, dtype, batch, dev, kernels)
    marks.append(("parity", time.perf_counter()))
    rows = []
    for family in ("runet", "rdcnet"):
        step_ms = {"f32": fits[family, torch.float32]["step_ms"],
                   "bf16": fits[family, torch.bfloat16]["step_ms"]}
        rows += rtrain_input_grad_rows(family, batch, dev, step_ms)
    marks.append(("input gradients", time.perf_counter()))
    rtrain_tf32(batch, dev)
    marks.append(("F4", time.perf_counter()))
    trained_gate(dev)
    marks.append(("trained gate", time.perf_counter()))
    rtrain_cli(dev)
    marks.append(("cli", time.perf_counter()))
    torch.cuda.empty_cache()
    split = ", ".join(f"{name} {t - t0:.1f}" for (name, t), (_n, t0) in
                      zip(marks, [("start", t_phase)] + marks[:-1]))
    print(f"rtrain phase: {time.perf_counter() - t_phase:.1f} s ({split})", flush=True)
    return rows, launches


# the detection training phase: full-width ResNet50-FPN, 5 classes (as
# train-rcnn without --simple-class), synthetic sections
DTRAIN_HW = (512, 512)
DTRAIN_BOXES = (20, 60)
DTRAIN_MAX_GT = 64
DTRAIN_STEPS = 20
DTRAIN_BATCH = 4
DTRAIN_LR = 1e-4
PRETRAIN_STEPS = 100
LABEL_NAMES = {1: "OHC1", 2: "OHC2", 3: "OHC3", 4: "IHC"}


def section_sample(seed, hw=DTRAIN_HW) -> tuple:
    """A synthetic section [1, H, W, 3] in [0, 1] with 20-60 cells, each a
    bright ellipse whose color follows its class (1-4), and the cells'
    boxes ``(x1, y1, x2, y2)`` and labels."""
    H, W = hw
    rng = np.random.default_rng(seed)
    img = rng.normal(0.12, 0.03, (H, W, 3))
    yy, xx = np.mgrid[0:H, 0:W]
    palette = {1: (0.9, 0.4, 0.3), 2: (0.4, 0.9, 0.3), 3: (0.3, 0.4, 0.9), 4: (0.9, 0.9, 0.5)}
    n = int(rng.integers(DTRAIN_BOXES[0], DTRAIN_BOXES[1] + 1))
    boxes, labels = [], []
    for _ in range(n):
        w, h = rng.uniform(12, 30, 2)
        x0, y0 = rng.uniform(2, W - w - 2), rng.uniform(2, H - h - 2)
        label = int(rng.integers(1, 5))
        inside = ((xx - x0 - w / 2) / (w / 2)) ** 2 + ((yy - y0 - h / 2) / (h / 2)) ** 2 < 1
        img[inside] = 0.5 * img[inside] + 0.5 * np.asarray(palette[label])
        boxes.append((round(x0), round(y0), round(x0 + w), round(y0 + h)))
        labels.append(label)
    return (np.clip(img, 0, 1).astype(np.float32)[None], np.asarray(boxes, np.float32),
            np.asarray(labels, np.int32))


def write_section(root, name, sample) -> None:
    """A section as ``<name>.tif`` (uint8 RGB) and ``<name>.xml`` (VOC)."""
    from hcunet_tpu_torch.data.tiff import imwrite

    img, boxes, labels = sample
    imwrite(os.path.join(root, f"{name}.tif"), (img[0] * 255).astype(np.uint8))
    objects = "".join(
        f"<object><name>{LABEL_NAMES[int(c)]}</name><bndbox><xmin>{int(b[0])}</xmin>"
        f"<ymin>{int(b[1])}</ymin><xmax>{int(b[2])}</xmax><ymax>{int(b[3])}</ymax></bndbox>"
        f"</object>" for b, c in zip(boxes, labels))
    with open(os.path.join(root, f"{name}.xml"), "w") as f:
        f.write(f"<annotation>{objects}</annotation>")


def train_detector(seed=SEED):
    """The ResNet50-FPN ``Detector`` (width 64, float32, 5 classes) with the
    JAX ``Detector.init``'s distributions from ``seed``, on the CPU."""
    from hcunet_tpu_torch.config import DetectorConfig
    from hcunet_tpu_torch.models.detection import Detector
    from hcunet_tpu_torch.models.unet import init_like_flax

    det = Detector(DetectorConfig(num_classes=5), backbone="resnet50", device="cpu")
    return init_like_flax(det, torch.Generator().manual_seed(seed), scale=1.0)


def detection_trainer(det, dev, lr=DTRAIN_LR):
    from hcunet_tpu_torch.train.detection_trainer import DetectionTrainConfig, DetectionTrainer

    return DetectionTrainer(det, cfg=DetectionTrainConfig(learning_rate=lr, max_gt=DTRAIN_MAX_GT),
                            device=dev)


def detector_losses_and_grads(det, sample, dev) -> tuple:
    """One ``Detector.losses`` (B=1, ``DTRAIN_MAX_GT`` slots) and its
    backward on ``dev``: the four terms, the new running statistics and
    the gradients, as the JAX trees of ``train/parity.py``."""
    from hcunet_tpu_torch.utils.port_jax import jax_variables_from_detector_state_dict

    trainer = detection_trainer(det, dev)
    img, boxes, labels = sample
    det.zero_grad(set_to_none=True)
    total, losses, stats = trainer._sample_loss(
        torch.from_numpy(img).to(dev), {"boxes": boxes, "labels": labels})
    total.backward()
    sd = {k: v.detach().cpu() for k, v in det.state_dict().items()}
    sd.update({k: v.cpu() for k, v in stats.items()})
    stats_tree = jax_variables_from_detector_state_dict(sd, "resnet50")["trunk"]["batch_stats"]
    g = jax_variables_from_detector_state_dict(
        dict(sd, **{n: p.grad.cpu() for n, p in det.named_parameters()}), "resnet50")
    grads = {"trunk": g["trunk"]["params"], "head": g["head"]["params"]}
    return {k: float(v.detach()) for k, v in losses.items()}, stats_tree, grads


def detector_gaps(a, b) -> dict:
    """The largest relative gap of the loss terms, the largest per-tensor
    gradient gap (``train/parity.py::gradient_gaps``: the norm of the
    difference over the norm, the BN-cancelled biases left out) with its
    tensor, and the running statistics' largest gap over max(1, scale)."""
    from hcunet_tpu_torch.train.parity import flat, gradient_gaps

    loss = max(abs(a[0][k] - b[0][k]) / abs(b[0][k]) for k in b[0])
    ga, gb = flat(a[2]), flat(b[2])
    # the zero-init last BN of each bottleneck leaves its branch's gradients
    # exactly 0 on the first step: held to 0 on the other side too
    zero = {p for p, v in gb.items() if not np.any(v)}
    if any(np.any(ga[p]) for p in zero):
        raise AssertionError(f"gradients 0 on one side only: {sorted(zero)[:4]}")
    g = gradient_gaps({"/".join(p): v for p, v in ga.items() if p not in zero},
                      {"/".join(p): v for p, v in gb.items() if p not in zero})
    worst = max(g, key=g.get)
    sa, sb = flat(a[1]), flat(b[1])
    stats = max(float(np.abs(sa[k] - v).max()) / max(1.0, float(np.abs(v).max()))
                for k, v in sb.items())
    return {"loss": loss, "grad": g[worst], "grad_at": "/".join(worst), "stats": stats,
            "zero_grads": len(zero)}


@contextlib.contextmanager
def jittered_layers(model, gen):
    """Each conv and linear output of ``model`` multiplied by ``1 + JITTER
    u`` (u uniform in [-1, 1], per element, from ``gen``), as another float32
    summation order would move it: the jittered runs of the parity rule."""
    def hook(_module, _inputs, out):
        u = torch.rand(out.shape, generator=gen, device=out.device) * 2 - 1
        return out * (1 + JITTER * u)

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def dtrain_parity(dev, sample) -> None:
    """The card's first-step loss terms, running statistics and gradients
    against the port on the CPU of the same machine, on the same weights
    and image (TF32 off), held as ``trajectory_gap`` holds K1's training
    runs: within ``JITTER_FACTOR`` times the largest gap that ``N_JITTER``
    card runs with jittered conv and linear outputs open, plus
    ``GAP_FLOOR`` (float32).  cuDNN's and the CPU's convs sum in other
    orders, and through ~50 train-mode batch norms the deep layers'
    first-step gradients move by far more than float32's epsilon."""
    sd0 = train_detector(SEED + 1).state_dict()

    def run(where, gen=None):
        det = train_detector(SEED + 1)
        det.load_state_dict(sd0)
        with jittered_layers(det, gen) if gen is not None else contextlib.nullcontext():
            return detector_losses_and_grads(det, sample, where)

    card = run(dev)
    cpu = run(torch.device("cpu"))
    noise = [detector_gaps(run(dev, torch.Generator(device=dev).manual_seed(SEED + i)), card)
             for i in range(N_JITTER)]
    torch.cuda.empty_cache()
    got = detector_gaps(card, cpu)
    factor, floor = JITTER_FACTOR[torch.float32], GAP_FLOOR[torch.float32]
    parts, bad = [], []
    for kind in ("loss", "grad", "stats"):
        n = max(r[kind] for r in noise)
        allowed = factor * n + floor[kind]
        where = f" ({got['grad_at']})" if kind == "grad" else ""
        parts.append(f"{kind} gap {got[kind]:.2e}{where}, jittered runs "
                     f"{', '.join(f'{r[kind]:.2e}' for r in noise)}, allowed {allowed:.2e}")
        if got[kind] > allowed:
            bad.append(kind)
    print(f"dtrain parity, first step, card vs CPU: losses {card[0]} vs {cpu[0]}; "
          f"{got['zero_grads']} gradients exactly 0 on both sides (the zero-init last BNs' "
          f"branches); {'; '.join(parts)}", flush=True)
    if bad:
        raise AssertionError(f"the detector's first step on the card parts from the CPU's: {bad}")


def dtrain_tf32(dev, sample) -> None:
    """Fault F4 for ``train-rcnn``: the first step's loss terms with TF32 at
    torch's defaults against TF32 off, from the same weights."""
    det = train_detector(SEED + 1)
    trainer = detection_trainer(det, dev)
    img, boxes, labels = sample
    got = {}
    for label, on in (("off", False), ("defaults", True)):
        with tf32(on), torch.no_grad():
            _t, losses, _s = trainer._sample_loss(torch.from_numpy(img).to(dev),
                                                 {"boxes": boxes, "labels": labels})
        got[label] = {k: float(v) for k, v in losses.items()}
    rel = {k: f"{abs(got['defaults'][k] - v) / abs(v):.3e}" for k, v in got["off"].items()}
    print(f"F4 train-rcnn first step: loss terms with TF32 off {got['off']}, at torch's "
          f"defaults {got['defaults']}: relative gaps {rel}", flush=True)
    del trainer, det
    torch.cuda.empty_cache()


def dtrain_fit(dev, samples) -> object:
    """``DetectionTrainer`` at B=1 for ``DTRAIN_STEPS`` steps on one section
    (the loss must fall) and at B=``DTRAIN_BATCH`` for 3 steps on four; ms
    a step, the peak memory and the loss terms at the first and last step.
    Returns the trained detector."""
    det = train_detector()
    trainer = detection_trainer(det, dev)
    for label, steps, group in (("B=1", DTRAIN_STEPS, samples[:1]),
                                (f"B={DTRAIN_BATCH}", 3, samples[:DTRAIN_BATCH])):
        images = np.concatenate([s[0] for s in group])
        targets = [{"boxes": s[1], "labels": s[2]} for s in group]
        totals, terms, secs = [], [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(steps):
            t0 = time.perf_counter()
            if len(group) == 1:
                totals.append(trainer.train_step(images, targets[0]["boxes"],
                                                 targets[0]["labels"]))
            else:
                totals.append(trainer.train_step_batch(images, targets))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            terms.append({k: round(v, 5) for k, v in trainer.last_losses.items()})
        peak = torch.cuda.max_memory_allocated()
        print(f"dtrain fit {label} (ResNet50-FPN width 64, float32, 5 classes, "
              f"{[len(s[2]) for s in group]} boxes, max_gt {DTRAIN_MAX_GT}, AdamW({DTRAIN_LR})): "
              f"{steps} steps, loss {totals[0]:.5f} -> {totals[-1]:.5f}; "
              f"{float(np.median(secs[1:])) * 1e3:.3f} ms a step (median of steps 2-{steps}; "
              f"step 1 {secs[0] * 1e3:.1f} ms); peak device memory {peak / 2**30:.2f} GiB; "
              f"terms first {terms[0]}, last {terms[-1]}", flush=True)
        if not all(math.isfinite(v) for v in totals):
            raise AssertionError(f"dtrain {label}: a loss is not finite: {totals}")
        if len(group) == 1 and not totals[-1] < totals[0]:
            raise AssertionError(f"dtrain {label}: the loss did not fall: {totals}")
    return det


def dtrain_map(det, samples) -> None:
    """``evaluate_detections`` on the trained detector's detections of the
    sections (no gate on the value)."""
    from hcunet_tpu_torch.analysis.detection_metrics import evaluate_detections

    out = det.detect(np.concatenate([s[0] for s in samples]))
    out = {k: v.cpu().numpy() for k, v in out.items()}
    preds = [{k: out[k][i][out["valid"][i]] for k in ("boxes", "scores", "labels")}
             for i in range(len(samples))]
    gts = [{"boxes": s[1], "labels": s[2]} for s in samples]
    res = evaluate_detections(preds, gts)
    print(f"evaluate_detections on the trained detector's {sum(len(p['scores']) for p in preds)} "
          f"detections of {len(samples)} sections ({sum(len(g['labels']) for g in gts)} boxes): "
          f"mAP@0.5 {res['map']:.4f}, recall {res['recall']:.4f}, AP per class "
          f"{ {c: round(v['ap'], 4) for c, v in res['per_class'].items()} }", flush=True)


def dtrain_pretrain(det) -> None:
    """``pretrain_backbone`` at width 64 (batch 16, 64 x 64,
    ``PRETRAIN_STEPS`` steps; its accuracy printed) and
    ``seed_detector_backbone`` applied to ``det``."""
    from hcunet_tpu_torch.train.pretrain import pretrain_backbone, seed_detector_backbone
    from hcunet_tpu_torch.utils.port_jax import (
        detector_state_dict_from_jax_variables,
        jax_variables_from_detector_state_dict,
    )

    t0 = time.perf_counter()
    backbone = pretrain_backbone(steps=PRETRAIN_STEPS, batch=16, width=64, hw=(64, 64),
                                 log_every=25, progress=lambda m: print(f"  {m}", flush=True),
                                 device=det.device)
    sec = time.perf_counter() - t0
    seeded = seed_detector_backbone(
        jax_variables_from_detector_state_dict(det.state_dict(), "resnet50"), backbone)
    det.load_state_dict(detector_state_dict_from_jax_variables(seeded, "resnet50"))
    got = det.backbone.body.conv1.weight.detach().cpu().numpy()
    want = np.transpose(backbone["params"]["stem_conv"]["kernel"], (3, 2, 0, 1))
    same = bool(np.array_equal(got, want))
    print(f"pretrain_backbone (width 64, batch 16, 64 x 64, {PRETRAIN_STEPS} steps): {sec:.2f} s; "
          f"seed_detector_backbone into the detector: stem equal {same}", flush=True)
    if not same:
        raise AssertionError("seed_detector_backbone did not seed the detector's trunk")


def dtrain_cli(model, dev, samples) -> None:
    """``train-rcnn --backbone resnet50 --epochs 1`` and ``pretrain-backbone
    --steps 20`` through ``cli.main``; the detector checkpoint then drives
    ``analyze --detector`` on the ``cli`` phase's ``CLI_SCENE`` with the U-Net
    ``model``."""
    from hcunet_tpu_torch.models.resnet import ResNet
    from hcunet_tpu_torch.train.pretrain import load_backbone
    from hcunet_tpu_torch.utils.checkpoint import load_model, save_checkpoint
    from hcunet_tpu_torch.utils.port_jax import (
        jax_backbone_from_state_dict,
        jax_variables_from_unet_state_dict,
    )

    root = tempfile.mkdtemp(prefix="chip_smoke_dtrain_")
    try:
        sections = os.path.join(root, "sections")
        os.makedirs(sections)
        for i, s in enumerate(samples[:2]):
            write_section(sections, f"sec{i}", s)
        det_ckpt = os.path.join(root, "detector.hcunet")
        t0 = time.perf_counter()
        info = cli_main(["train-rcnn", sections, "--epochs", "1", "--backbone", "resnet50",
                         "--out", det_ckpt])
        rcnn_s = time.perf_counter() - t0
        det, _v, _h = load_model(det_ckpt, device=dev)
        finite = all(bool(torch.isfinite(p).all()) for p in det.state_dict().values())
        bb = os.path.join(root, "backbone.msgpack")
        t0 = time.perf_counter()
        info_bb = cli_main(["pretrain-backbone", "--steps", "20", "--out", bb])
        bb_s = time.perf_counter() - t0
        load_backbone(bb, template=jax_backbone_from_state_dict(
            {f"b.{k}": v for k, v in ResNet().state_dict().items()}, prefix="b"))
        print(f"cli train-rcnn --backbone resnet50 --epochs 1 (2 sections {DTRAIN_HW}): "
              f"{rcnn_s:.2f} s, {info}, weights finite {finite}; pretrain-backbone --steps 20: "
              f"{bb_s:.2f} s, {info_bb}, read back against the trunk's template", flush=True)
        if info != {"checkpoint": det_ckpt} or not finite or info_bb != {"backbone": bb}:
            raise AssertionError("train-rcnn or pretrain-backbone wrote a bad file")
        unet = os.path.join(root, "unet.hcunet")
        save_checkpoint(unet, jax_variables_from_unet_state_dict(model.state_dict(), model.config),
                        model.config, snapshot_sources=False)
        stack = os.path.join(root, "stack")
        os.makedirs(stack)
        write_stack_sample(stack, "s0", SEED)
        t0 = time.perf_counter()
        out = cli_main(["analyze", os.path.join(stack, "s0.npy"), "--unet", unet, "--detector",
                        det_ckpt, "--numchunks", "2", "--no-cochlea",
                        "--out", os.path.join(root, "out")])
        print(f"cli analyze --detector <the train-rcnn checkpoint> on {CLI_SCENE}: "
              f"{time.perf_counter() - t0:.2f} s, {out}", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def dtrain_phase(model, dev) -> None:
    """Training of the detector on the card at full width (no TPU kernel's
    counterpart on its path: cuDNN's 2D convs, plain-torch RoIAlign and NMS):
    the first step against the CPU's; F4's TF32 gap of the first losses;
    ``DetectionTrainer`` at B=1 and B=4 on synthetic sections;
    ``evaluate_detections`` on its output; ``pretrain_backbone`` and
    ``seed_detector_backbone``; ``train-rcnn`` and ``pretrain-backbone``
    through ``cli.main`` and the trained checkpoint through ``analyze
    --detector`` with the U-Net ``model``."""
    t_phase = time.perf_counter()
    marks = []
    samples = [section_sample(SEED + i) for i in range(DTRAIN_BATCH)]
    marks.append(("sections", time.perf_counter()))
    dtrain_parity(dev, samples[0])
    marks.append(("card vs CPU", time.perf_counter()))
    dtrain_tf32(dev, samples[0])
    marks.append(("F4", time.perf_counter()))
    det = dtrain_fit(dev, samples)
    marks.append(("fit", time.perf_counter()))
    dtrain_map(det, samples)
    marks.append(("mAP", time.perf_counter()))
    dtrain_pretrain(det)
    del det
    torch.cuda.empty_cache()
    marks.append(("pretrain", time.perf_counter()))
    dtrain_cli(model, dev, samples)
    marks.append(("cli", time.perf_counter()))
    torch.cuda.empty_cache()
    split = ", ".join(f"{name} {t - t0:.1f}" for (name, t), (_n, t0) in
                      zip(marks, [("start", t_phase)] + marks[:-1]))
    print(f"dtrain phase: {time.perf_counter() - t_phase:.1f} s ({split})", flush=True)


# phases that --phases can pick, in the order they run, and the kernels
# each launches
# the mesh phase: the port's multi-device paths over a mesh of the card(s)
MESH_REQUEST = (1152, 1152, 15)
MESH_UNET_STEPS = 5
MESH_RTRAIN_STEPS = 3
MESH_DTRAIN_STEPS = 2


def mesh_devices(k: int) -> list:
    """``k`` distinct cards where the machine has them, else ``cuda:0``
    repeated ``k`` times."""
    n = torch.cuda.device_count()
    return [torch.device("cuda", i if n >= k else 0) for i in range(k)]


def timed(fn) -> tuple:
    """``fn()`` and its seconds, the card synchronized before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def share_gap(got, want) -> tuple:
    """``max |got - want|`` over ``max |want|``, and whether the two are
    bit-equal."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)), bool(
        np.array_equal(got, want))


def sharded_tile_batches(seg, spatial) -> int:
    """Tile batches of a sharded request, summed over the shards: each slab
    runs its own grid (whole X columns, Y and Z rounded up) in batches."""
    bucket = seg.bucket_shape(spatial)
    ex, ey, ez = seg.tile_cfg.eval_size
    n = seg._n_shards
    tiles = (bucket[0] // n // ex) * -(-bucket[1] // ey) * -(-bucket[2] // ez)
    return n * -(-tiles // seg.tile_cfg.batch)


def mesh_serving(model, dev, card, kernel) -> int:
    """(a) ``Segmenter(mesh=spatial 2)`` against one device on a
    ``MESH_REQUEST`` volume, bf16 and float32.  Returns K1's launches in
    the mesh requests."""
    from hcunet_tpu_torch.infer.serving import Segmenter
    from hcunet_tpu_torch.ops.tconv import TCONV3D_SUBPIXEL
    from hcunet_tpu_torch.parallel.mesh import SPATIAL_AXIS, make_mesh

    mesh = make_mesh({SPATIAL_AXIS: 2}, mesh_devices(2))
    vol = np.random.default_rng(SEED).random((*MESH_REQUEST, model.config.in_channels),
                                             dtype=np.float32)
    launches = 0
    for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-5)):
        seg1 = Segmenter(model, dtype=dtype, device=dev)
        segm = Segmenter(model, dtype=dtype, mesh=mesh, tile_cfg=seg1.tile_cfg)
        seg1.predict(vol)
        segm.predict(vol)  # warm both
        want, s1 = timed(lambda: seg1.predict(vol))
        reset_counts([kernel])
        tconv0 = TCONV3D_SUBPIXEL.launches
        got, sm = timed(lambda: segm.predict(vol))
        n, routes = kernel.launches, dict(kernel.route_launches)
        tconv = TCONV3D_SUBPIXEL.launches - tconv0
        batches = sharded_tile_batches(segm, vol.shape[:-1])
        gap, equal = share_gap(got, want)
        dt = "bf16" if dtype == torch.bfloat16 else "f32"
        print(f"mesh serving {MESH_REQUEST} {dt} ({card}): spatial 2 {1e3 * sm:.1f} ms a request,"
              f" one device {1e3 * s1:.1f} ms; bucket {segm.bucket_shape(MESH_REQUEST)}; "
              f"|mesh - single| / scale {gap:.3e} (gate {tol:g}), bit-equal {equal}; K1 {n} "
              f"launches {routes} = 15 x {batches} tile batches over the shards, the "
              f"transposed-conv kernel {tconv}", flush=True)
        if n != 15 * batches:
            raise AssertionError(f"mesh serving launched K1 {n} times, expected {15 * batches}")
        check_k1_routes(routes, batches, dtype)
        check_tconv(f"mesh serving {dt}", tconv, batches, dtype)
        if not gap <= tol:
            raise AssertionError(f"mesh serving {dt} parts from one device by {gap:.3e}")
        launches += n
        del seg1, segm
        torch.cuda.empty_cache()
    return launches


def mesh_analyze(model, dev, card, kernel, ref=None) -> int:
    """(b) ``analyze(mesh=spatial 2)`` on the ``cli`` phase's scene with
    the U-Net served in float32 and the ResNet50-FPN detector, against one
    device: the ``cli`` phase's direct ``analyze`` (``ref``, its inputs
    and result) where that phase ran, else a run here on the same scene
    and models.  Returns K1's launches in the mesh run."""
    from hcunet_tpu_torch import PipelineConfig, analyze
    from hcunet_tpu_torch.infer.compile import compile_serving_apply
    from hcunet_tpu_torch.parallel.mesh import SPATIAL_AXIS, make_mesh

    root = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    torch.backends.cudnn.deterministic = True
    try:
        if not ref:
            ref = {"vol": write_stack_sample(root, "m0", SEED), "detector": build_detector(dev),
                   "apply": compile_serving_apply(model, dtype=torch.float32, device=dev),
                   "cfg": model.config}
        cfg = PipelineConfig(numchunks=2, unet=ref["cfg"])
        common = dict(volume=ref["vol"], unet_apply=ref["apply"], detector=ref["detector"],
                      cfg=cfg, fit_cochlea=False)
        if "result" not in ref:
            ref["result"], ref["seconds"] = timed(lambda: analyze(
                work_dir=os.path.join(root, "single"), device=dev, **common))
            with open(os.path.join(root, "single", "cells.csv"), "rb") as f:
                ref["csv"] = f.read()
        single, s1 = ref["result"], ref["seconds"]
        mesh = make_mesh({SPATIAL_AXIS: 2}, mesh_devices(2))
        reset_counts([kernel])
        res, sm = timed(lambda: analyze(work_dir=os.path.join(root, "mesh"), mesh=mesh,
                                        **common))
        n = kernel.launches
        with open(os.path.join(root, "mesh", "cells.csv"), "rb") as f:
            csv = [ref["csv"], f.read()]
        dp = float(np.abs(res.mask.astype(np.float64) - single.mask).max())
        chunks = (cfg.numchunks - 1) ** 2
        print(f"mesh analyze {CLI_SCENE} float32 ({card}): spatial 2 {sm:.3f} s, one device "
              f"{s1:.3f} s; max |dp| {dp:.3e} (gate 1e-5); cells {len(res.cells)} / "
              f"{len(single.cells)}, cells.csv byte-equal {csv[0] == csv[1]}; mesh_chunks "
              f"{res.mesh_chunks}; K1 {n} launches", flush=True)
        if res.mesh_chunks != {"sharded": chunks, "fallback": 0}:
            raise AssertionError(f"mesh analyze chunks {res.mesh_chunks}")
        if not dp <= 1e-5 or csv[0] != csv[1] or n == 0:
            raise AssertionError("mesh analyze parts from one device")
        return n
    finally:
        torch.backends.cudnn.deterministic = False
        shutil.rmtree(root, ignore_errors=True)


def mesh_recurrent(dev, card, kernel) -> int:
    """(c) ``compile_recurrent_apply(mesh=spatial 2, split_x=2)`` for both
    families at full width against ``split_x=2`` without a mesh, bf16 and
    float32.  Returns K1's launches in the mesh forwards."""
    from hcunet_tpu_torch.config import RDCNetConfig, RUNetConfig
    from hcunet_tpu_torch.infer.compile_recurrent import compile_recurrent_apply
    from hcunet_tpu_torch.models.rdcnet import RDCNet
    from hcunet_tpu_torch.models.runet import RecursiveUNet
    from hcunet_tpu_torch.parallel.mesh import SPATIAL_AXIS, make_mesh

    mesh = make_mesh({SPATIAL_AXIS: 2}, mesh_devices(2))
    gen = torch.Generator().manual_seed(SEED)
    x = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        (1, *RECURRENT_SCENE, 4)).astype(np.float32)).to(dev)
    launches = 0
    torch.backends.cudnn.deterministic = True  # RDCNet's conv_transpose3d, run to run
    try:
        for family, model in (("RecursiveUNet", RecursiveUNet(RUNetConfig())),
                              ("RDCNet", RDCNet(RDCNetConfig()))):
            model = build_recurrent(model, gen)
            for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-5)):
                split = compile_recurrent_apply(model, dtype=dtype, device=dev, split_x=2)
                sharded = compile_recurrent_apply(model, dtype=dtype, split_x=2, mesh=mesh)
                split(x)
                sharded(x)  # warm both
                reset_counts([kernel])
                want, s1 = timed(lambda: split(x))
                n1 = kernel.launches
                reset_counts([kernel])
                got, sm = timed(lambda: sharded(x))
                n = kernel.launches
                gap, equal = share_gap(got.cpu(), want.cpu())
                # each device runs its tile alone: twice the batched split's
                # launches, but RDCNet's output conv runs once on the whole
                expect = 2 * n1 if family == "RecursiveUNet" else 2 * (n1 - 1) + 1
                dt = "bf16" if dtype == torch.bfloat16 else "f32"
                print(f"mesh {family} {RECURRENT_SCENE} {dt} ({card}): spatial 2 "
                      f"{1e3 * sm:.1f} ms a forward, split_x=2 on one device {1e3 * s1:.1f} ms; "
                      f"|mesh - split| / scale {gap:.3e} (gate {tol:g}), bit-equal {equal}; "
                      f"K1 {n} launches (split {n1})", flush=True)
                if n != expect or not gap <= tol:
                    raise AssertionError(f"mesh {family} {dt}: {n} launches (expected {expect}),"
                                         f" gap {gap:.3e}")
                launches += n
    finally:
        torch.backends.cudnn.deterministic = False
    return launches


def mesh_train_runs(label, card, make, step, steps, kernels, per_step):
    """``steps`` steps of a mesh trainer and of a one-device one from the
    same start on the same global batches, the losses held to rtol 1e-4;
    ``per_step`` (K1's forward and input-gradient launches a mesh step, or
    None) is checked each step.  Returns the mesh steps' launches."""
    fwd_k, grad_k = kernels
    runs, launches = {}, {"forward": 0, "input_grad": 0}
    for name in ("mesh", "single"):
        trainer = make(name == "mesh")
        losses, secs = [], []
        for _ in range(steps):
            reset_counts([fwd_k, grad_k])
            loss, sec = timed(lambda: step(trainer))
            losses.append(loss)
            secs.append(sec)
            if name == "mesh":
                got = (fwd_k.launches, grad_k.launches)
                launches["forward"] += got[0]
                launches["input_grad"] += got[1]
                if per_step is not None and got != per_step:
                    raise AssertionError(f"{label}: K1 {got} a mesh step, expected {per_step}")
        runs[name] = (losses, secs)
        del trainer
        torch.cuda.empty_cache()
    (lm, sm), (ls, ss) = runs["mesh"], runs["single"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(lm, ls))
    print(f"mesh training {label} ({card}): losses {lm} against one device {ls}, largest "
          f"relative gap {rel:.3e} (gate 1e-4); {1e3 * min(sm):.1f} ms a mesh step, "
          f"{1e3 * min(ss):.1f} ms on one device", flush=True)
    if not rel <= 1e-4:
        raise AssertionError(f"{label}: mesh training parts from one device by {rel:.3e}")
    return launches


def mesh_training(dev, card, kernels) -> dict:
    """(d) ``UNetTrainer`` on the 2 x 2 x 2 mesh (production width, float32,
    ``FIT_CROP``), ``RecurrentTrainer`` (RDCNet) and ``DetectionTrainer``
    (ResNet50-FPN, 512^2) on data 2, each against one device on the global
    batch of 2.  Returns K1's launches in the mesh steps."""
    import copy

    from hcunet_tpu_torch.config import UNetConfig
    from hcunet_tpu_torch.parallel.mesh import DATA_AXIS, make_mesh
    from hcunet_tpu_torch.train.detection_trainer import DetectionTrainConfig, DetectionTrainer
    from hcunet_tpu_torch.train.trainer import RecurrentTrainer, TrainConfig, UNetTrainer

    launches = {"forward": 0, "input_grad": 0}

    def add(got):
        for k in launches:
            launches[k] += got[k]

    # U-Net: data 2 x model 2 x spatial 2, the kernels of 32+ channels sliced
    x, y = fit_batch()
    xb = torch.from_numpy(np.concatenate([x, x[:, ::-1]])).to(dev)
    yb = torch.from_numpy(np.concatenate([y, y[:, ::-1]])).to(dev)
    start = build_model(UNetConfig.production_3d(), torch.Generator().manual_seed(SEED))
    grid = make_mesh({DATA_AXIS: 2, "model": 2, "spatial": 2}, mesh_devices(8))

    def unet_trainer(on_mesh):
        return UNetTrainer(copy.deepcopy(start), cfg=TrainConfig(log_every=0),
                           mesh=grid if on_mesh else None, device=None if on_mesh else dev)

    add(mesh_train_runs("UNet production_3d 2x2x2", card, unet_trainer,
                        lambda tr: tr.train_step(xb, yb, None), MESH_UNET_STEPS, kernels,
                        (30, 28)))

    # RDCNet: data 2
    pair = [recurrent_scene(RTRAIN_CROP, SEED + i)["batch"] for i in range(2)]
    rb = [torch.from_numpy(np.concatenate([a, b])).to(dev) for a, b in zip(*pair)]
    rstart = recurrent_model("rdcnet")
    data2 = make_mesh({DATA_AXIS: 2}, mesh_devices(2))

    def rdc_trainer(on_mesh):
        return RecurrentTrainer(copy.deepcopy(rstart), cfg=TrainConfig(log_every=0),
                                mesh=data2 if on_mesh else None, device=None if on_mesh else dev)

    n = 7 * rstart.config.timesteps + 1
    add(mesh_train_runs("RDCNet data 2", card, rdc_trainer,
                        lambda tr: tr.train_step(rb[0], rb[1], rb[2], rb[4]), MESH_RTRAIN_STEPS,
                        kernels, (2 * n, 2 * n)))

    # the detector: data 2, one image a replica
    samples = [section_sample(SEED + i) for i in range(2)]
    images = np.concatenate([s[0] for s in samples])
    targets = [{"boxes": s[1], "labels": s[2]} for s in samples]
    dstart = train_detector()

    def det_trainer(on_mesh):
        cfg = DetectionTrainConfig(learning_rate=DTRAIN_LR, max_gt=DTRAIN_MAX_GT)
        return DetectionTrainer(copy.deepcopy(dstart), cfg=cfg, batch_size=2,
                                mesh=data2 if on_mesh else None, device=None if on_mesh else dev)

    mesh_train_runs("ResNet50-FPN detector data 2", card, det_trainer,
                    lambda tr: tr.train_step_batch(images, targets), MESH_DTRAIN_STEPS,
                    kernels, (0, 0))
    return launches


def mesh_phase(model, dev, kernels, ref=None) -> dict:
    """The port's multi-device paths on the card: serving, ``analyze``,
    recurrent serving and the three trainers over a mesh (``mesh_devices``:
    distinct cards where there are enough, else the card repeated), each
    against one device; every mesh run's K1 launches counted, each run
    with the counts set to 0 just before it.  ``ref``: the ``cli`` phase's
    direct ``analyze`` (:func:`mesh_analyze`).  Returns the path's K1
    launches ``{"forward", "input_grad"}``."""
    fwd_k, _grad_k = kernels
    t_phase = time.perf_counter()
    card = card_line()
    print(f"mesh devices: {[str(d) for d in mesh_devices(8)]} (cards present: "
          f"{torch.cuda.device_count()}; a single card is repeated: these times are no "
          f"scaling figure)", flush=True)
    marks = []
    fwd = mesh_serving(model, dev, card, fwd_k)
    marks.append(("serving", time.perf_counter()))
    fwd += mesh_analyze(model, dev, card, fwd_k, ref)
    marks.append(("analyze", time.perf_counter()))
    fwd += mesh_recurrent(dev, card, fwd_k)
    marks.append(("recurrent", time.perf_counter()))
    train = mesh_training(dev, card, kernels)
    marks.append(("training", time.perf_counter()))
    split = ", ".join(f"{name} {t - t0:.1f}" for (name, t), (_n, t0) in
                      zip(marks, [("start", t_phase)] + marks[:-1]))
    print(f"mesh phase: {time.perf_counter() - t_phase:.1f} s ({split}; {card})", flush=True)
    return {"forward": fwd + train["forward"], "input_grad": train["input_grad"]}


# the hcat phase: the reference's driver surface (``hcunet_tpu_torch.hcat``)
# the import forms of the reference's drivers (``tests/test_reference_drivers.py``),
# their ``hcat`` prefix rewritten to the port's
HCAT_IMPORT_FORMS = [
    "from hcunet_tpu_torch.hcat.main import analyze\n"
    "from hcunet_tpu_torch.hcat.utils import cells_to_csv",
    "from hcunet_tpu_torch.hcat import dataloader, utils as u, transforms as t\n"
    "import hcunet_tpu_torch.hcat.train",
    "from hcunet_tpu_torch.hcat import haircell",
    "from hcunet_tpu_torch.hcat.unet import Unet_Constructor as GUnet\n"
    "import hcunet_tpu_torch.hcat.transforms as t\n"
    "from hcunet_tpu_torch.hcat import mask as m, utils, segment\n"
    "import hcunet_tpu_torch.hcat",
    "from hcunet_tpu_torch.hcat.train import train_utils\n"
    "mm = train_utils.makeMask(erosion=True)\n"
    "mpwl = train_utils.makePWL()\n"
    "com = train_utils.CalculateCenterOfMass()\n"
    "pix2center = train_utils.VectorToCenter()",
    "from hcunet_tpu_torch.hcat.r_unet import RecursiveUnet as RUnet, RDCNet",
    "from hcunet_tpu_torch.hcat.r_unet import StackedDilation, RDCNet",
    "from hcunet_tpu_torch.hcat.validate.render_size import render_size\n"
    "from hcunet_tpu_torch.hcat import loss\nfrom hcunet_tpu_torch.hcat import rcnn",
]
# K1 launches of one facade forward (10 timesteps, float32, all on the basic
# path): the RecursiveUNet's 17 same-padding convs a step (its transposed
# convs are cuDNN's in the eval model), RDCNet's 7 an iteration and its
# output conv
HCAT_R_UNET_LAUNCHES = {"RecursiveUnet": 10 * 17, "RDCNet": 10 * 7 + 1}
HCAT_SECTIONS = 2
HCAT_EPOCHS = 2


def hcat_imports() -> None:
    """The driver import forms resolve, and neither JAX, the JAX package nor
    its ``hcat`` alias came with them."""
    for form in HCAT_IMPORT_FORMS:
        exec(compile(form, "<driver import>", "exec"), {})
    leaked = sorted(k for k in sys.modules if k in ("jax", "hcunet_tpu", "hcat")
                    or k.startswith(("jax.", "hcunet_tpu.", "hcat.")))
    if leaked:
        raise AssertionError(f"the hcat driver imports brought in {leaked}")


def hcat_r_unet(dev, kernel, card) -> int:
    """``RecursiveUnet()`` and ``RDCNet()`` of ``hcunet_tpu_torch.hcat.r_unet``
    on the card (their default device) at the ``recurrent`` phase's geometry
    (B=1, float32): K1's launches of the timed forward equal to
    ``HCAT_R_UNET_LAUNCHES``, all basic, and the output within 1e-5 of the
    scale of the port's model applied directly on the same weights, cuDNN
    pinned deterministic (the transposed convs vary run to run otherwise).
    Returns the timed forwards' K1 launches."""
    x = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        (1, 4, *RECURRENT_SCENE)).astype(np.float32))
    launches = 0
    torch.backends.cudnn.deterministic = True  # the transposed convs, run to run
    try:
        for family, want_n in HCAT_R_UNET_LAUNCHES.items():
            launches += hcat_r_unet_family(family, want_n, x, dev, kernel, card)
    finally:
        torch.backends.cudnn.deterministic = False
    return launches


def hcat_r_unet_family(family, want_n, x, dev, kernel, card) -> int:
    """One facade of :func:`hcat_r_unet`; returns its timed forward's K1
    launches."""
    from hcunet_tpu_torch.hcat import r_unet

    fac = getattr(r_unet, family)(seed=SEED)
    if fac.device.type != "cuda":
        raise AssertionError(f"hcat.r_unet.{family}() sits on {fac.device}, not the card")
    fac(x)  # warm
    reset_counts([kernel])
    got, secs = timed(lambda: fac(x))
    n, routes = kernel.launches, dict(kernel.route_launches)
    with torch.no_grad():
        want = fac.model(x.to(dev).movedim(1, -1).contiguous()).movedim(-1, 1).cpu()
    gap, equal = share_gap(got, want.numpy())
    print(f"hcat.r_unet.{family}() {tuple(x.shape)} float32 ({card}): "
          f"{1e3 * secs:.1f} ms a forward (host clock, numpy in and out); "
          f"|facade - model| / scale {gap:.3e} (gate 1e-5), bit-equal {equal}; "
          f"K1 {n} launches {routes} (expected {want_n}, all basic)", flush=True)
    if (n != want_n or routes.get("ring") or not gap <= 1e-5
            or got.shape != (1, 5, *RECURRENT_SCENE) or not np.isfinite(got).all()):
        raise AssertionError(f"hcat.r_unet.{family}: {n} launches {routes}, gap {gap:.3e}, "
                             f"shape {got.shape}")
    del fac
    torch.cuda.empty_cache()
    return n


def hcat_frcnn(dev, card) -> None:
    """``hcat.train.frcnn`` for ``HCAT_EPOCHS`` epochs over
    ``HCAT_SECTIONS`` synthetic 512^2 sections with the ``dtrain`` phase's
    detector behind ``hcat.rcnn``, against ``DetectionTrainer`` on the same
    weights, sections and recipe: each summed loss finite and within rtol
    1e-4 (cuDNN pinned deterministic for both runs)."""
    from hcunet_tpu_torch.config import DetectorConfig
    from hcunet_tpu_torch.hcat import train
    from hcunet_tpu_torch.hcat.rcnn import rcnn
    from hcunet_tpu_torch.train.detection_trainer import DetectionTrainConfig, DetectionTrainer

    samples = [section_sample(SEED + i) for i in range(HCAT_SECTIONS)]
    dataset = [(img, {"boxes": boxes, "labels": labels}) for img, boxes, labels in samples]
    start = train_detector().state_dict()
    torch.backends.cudnn.deterministic = True
    try:
        model = rcnn(config=DetectorConfig(num_classes=5), backbone="resnet50")
        model.detector.load_state_dict(start)
        if model.detector.device.type != "cuda":
            raise AssertionError(f"hcat.rcnn() sits on {model.detector.device}, not the card")
        (_m, got), secs = timed(lambda: train.frcnn(
            model, dataset, optimizer=None, scheduler=None, epochs=HCAT_EPOCHS,
            lr=DTRAIN_LR))
        det = train_detector()
        det.load_state_dict(start)
        trainer = DetectionTrainer(det, None, DetectionTrainConfig(
            learning_rate=DTRAIN_LR, gamma=0.997, classifier_scale=1.0, epochs=HCAT_EPOCHS),
            steps_per_epoch=len(dataset), device=dev)
        want, secs_t = timed(lambda: trainer.fit(dataset, epochs=HCAT_EPOCHS))
    finally:
        torch.backends.cudnn.deterministic = False
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    print(f"hcat.train.frcnn ({card}): {HCAT_EPOCHS} epochs over {HCAT_SECTIONS} sections "
          f"{DTRAIN_HW} (ResNet50-FPN width 64, float32, {[len(s[2]) for s in samples]} boxes): "
          f"summed losses {got} against DetectionTrainer {want}, largest relative gap "
          f"{rel:.3e} (gate 1e-4); {secs:.2f} s (DetectionTrainer {secs_t:.2f} s)", flush=True)
    if len(got) != HCAT_EPOCHS or not all(math.isfinite(v) for v in got) or not rel <= 1e-4:
        raise AssertionError(f"hcat.train.frcnn: {got} against {want}")


def hcat_loss(dev, card) -> None:
    """``hcat.loss``'s four functions on channels-first CUDA tensors against
    the same calls on CPU tensors: the deterministic methods within 1e-6
    relative; ``method="random"`` (a CUDA generator draws other pixels
    than a CPU one) finite on both."""
    from hcunet_tpu_torch.hcat import loss

    rng = np.random.default_rng(SEED)
    pred = torch.from_numpy(rng.standard_normal((1, 1, *RECURRENT_SCENE)).astype(np.float32))
    big = (1, 1, *(s + 4 for s in RECURRENT_SCENE))  # a valid-conv target is larger
    mask = torch.from_numpy((rng.random(big) > 0.7).astype(np.float32))
    pwl = torch.from_numpy(rng.random(big).astype(np.float32) * 5)
    calls = {f"cross_entropy {m}": (lambda m: lambda p, k, w: loss.cross_entropy(p, k, w, method=m))(m)
             for m in ("pixel", "worst_z", "sigmoid")}
    calls.update(dice=lambda p, k, w: loss.dice(p, k), L1Loss=lambda p, k, w: loss.L1Loss(p, k),
                 MSELoss=lambda p, k, w: loss.MSELoss(p, k))
    gaps = {}
    for name, fn in calls.items():
        got, want = fn(pred.to(dev), mask.to(dev), pwl.to(dev)), fn(pred, mask, pwl)
        gaps[name] = abs(got - want) / abs(want)
        if not (isinstance(got, float) and gaps[name] <= 1e-6):
            raise AssertionError(f"hcat.loss.{name}: card {got!r}, CPU {want!r}")
    rnd = [loss.cross_entropy(p, k, w, method="random", num_random_pixels=1000)
           for p, k, w in ((pred.to(dev), mask.to(dev), pwl.to(dev)), (pred, mask, pwl))]
    print(f"hcat.loss on the card against the CPU ({card}): relative gaps "
          + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items())
          + f" (gate 1e-6); random: card {rnd[0]:.6f}, CPU {rnd[1]:.6f}", flush=True)
    if not all(math.isfinite(v) for v in rnd):
        raise AssertionError(f"hcat.loss.cross_entropy random: {rnd}")


def hcat_host_parts(dev, card) -> None:
    """``hcat.utils.pad_image_with_reflections`` on a CUDA tensor stays on
    the card and equals ``reflection_pad_np``; the four window filters on a
    CUDA volume equal their CPU results exactly."""
    from hcunet_tpu_torch.core.padding import reflection_pad_np
    from hcunet_tpu_torch.hcat.utils import pad_image_with_reflections
    from hcunet_tpu_torch.ops import filters

    rng = np.random.default_rng(SEED)
    vol = rng.standard_normal((1, 4, *RECURRENT_SCENE)).astype(np.float32)
    got = pad_image_with_reflections(torch.from_numpy(vol).to(dev), (30, 30, 6))
    want = np.moveaxis(reflection_pad_np(np.moveaxis(vol, 1, -1), (30, 30, 6)), -1, 1)
    if got.device.type != "cuda" or not np.array_equal(got.cpu().numpy(), want):
        raise AssertionError(f"pad_image_with_reflections on the card: {got.device}, "
                             f"{tuple(got.shape)} against {want.shape}")
    x = torch.from_numpy(vol[0, 0])
    cases = {"maximum_filter size 2": lambda t: filters.maximum_filter(t, 2),
             "maximum_filter size 3 xy": lambda t: filters.maximum_filter(t, 3, axes=(0, 1)),
             "binary_dilation": lambda t: filters.binary_dilation(t > 0.5),
             "binary_erosion": lambda t: filters.binary_erosion(t > -0.5),
             "binary_dilation_n 15 xy": lambda t: filters.binary_dilation_n(t > 2.5, 15,
                                                                            axes=(0, 1))}
    for name, fn in cases.items():
        g, w = fn(x.to(dev)), fn(x)
        if g.device.type != "cuda" or g.dtype != w.dtype or not torch.equal(g.cpu(), w):
            raise AssertionError(f"{name} on the card differs from the CPU")
    print(f"hcat host parts ({card}): pad_image_with_reflections {tuple(got.shape)} on the card "
          f"equal to reflection_pad_np; {', '.join(cases)} on {tuple(x.shape)} equal to the "
          f"CPU", flush=True)


def hcat_phase(dev, kernel) -> int:
    """The reference's driver surface on the card, through
    ``hcunet_tpu_torch.hcat``: the driver import forms, the ``r_unet``
    facades (their timed forwards' K1 launches counted with the count set to
    0 just before each), ``train.frcnn`` against ``DetectionTrainer``,
    ``loss`` on the card against the CPU, and the padding and filters on the
    card.  Returns the path's K1 launches."""
    t_phase = time.perf_counter()
    card = card_line()
    marks = []
    hcat_imports()
    marks.append(("imports", time.perf_counter()))
    launches = hcat_r_unet(dev, kernel, card)
    marks.append(("r_unet", time.perf_counter()))
    hcat_frcnn(dev, card)
    torch.cuda.empty_cache()
    marks.append(("frcnn", time.perf_counter()))
    hcat_loss(dev, card)
    marks.append(("loss", time.perf_counter()))
    hcat_host_parts(dev, card)
    marks.append(("padding and filters", time.perf_counter()))
    split = ", ".join(f"{name} {t - t0:.1f}" for (name, t), (_n, t0) in
                      zip(marks, [("start", t_phase)] + marks[:-1]))
    print(f"hcat phase: {time.perf_counter() - t_phase:.1f} s ({split}; {card})", flush=True)
    return launches


# the bench phase: the command line's bench at full size under this budget,
# and the pipeline metric in-process on the cli phase's scene with a soft
# deadline this far away (a cut of depth: PERF.md section 4)
BENCH_BUDGET_S = 240
BENCH_PIPELINE_DEADLINE_S = 30.0
BENCH_METRICS = ("tiled_unet3d_inference", "recurrent_packed_serving")


def check_bench_record(rec, keys) -> None:
    """A bench record: the twin's ``keys`` and ``device``, a finite value
    above 0, measured on an H100."""
    if set(rec) != set(keys) | {"device"}:
        raise AssertionError(f"bench record keys {sorted(rec)}, expected {sorted(keys)} + device")
    if not (math.isfinite(rec["value"]) and rec["value"] > 0):
        raise AssertionError(f"bench value {rec['value']}")
    if "H100" not in rec["device"]["name"]:
        raise AssertionError(f"bench device {rec['device']}")


def bench_cli(cache_dir) -> list:
    """``python -m hcunet_tpu_torch.cli bench --headline --recurrent`` as a
    user runs it, at full size, with ``HCUNET_BENCH_BUDGET_S`` at
    ``BENCH_BUDGET_S`` and its ledger in ``cache_dir``: exit code 0 and one
    value line per metric, no error or skip.  The command and its metric
    children run in a process group of their own, killed if it outlives its
    budget.  Returns the records."""
    env = dict(os.environ, HCUNET_BENCH_BUDGET_S=str(BENCH_BUDGET_S), HCUNET_CACHE_DIR=cache_dir)
    env.pop("HCUNET_NO_CACHE", None)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "hcunet_tpu_torch.cli", "bench", "--headline", "--recurrent"],
        cwd=Path(__file__).resolve().parent, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True,
    )
    try:
        out, err = proc.communicate(timeout=BENCH_BUDGET_S + 60)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
            proc.communicate()
    secs = time.perf_counter() - t0
    lines = [line for line in out.splitlines() if line.strip()]
    for line in lines:
        print(f"bench: {line}", flush=True)
    print(f"bench --headline --recurrent: exit code {proc.returncode} in {secs:.1f} s "
          f"(budget {BENCH_BUDGET_S} s)", flush=True)
    if proc.returncode != 0:
        print(err[-4000:], file=sys.stderr, flush=True)
        raise AssertionError(f"bench exited {proc.returncode}")
    records = [json.loads(line) for line in lines if line.startswith("{")]
    if [r.get("metric") for r in records] != list(BENCH_METRICS):
        raise AssertionError(f"bench printed {records}, expected one line per {BENCH_METRICS}")
    for rec in records:
        if "error" in rec or "skipped" in rec:
            raise AssertionError(f"bench line {rec}")
        check_bench_record(rec, {"metric", "value", "unit", "vs_baseline", "reps"})
    return records


def bench_inits(dev) -> None:
    """The seeded inits of the bench's three models, each on the card."""
    from hcunet_tpu_torch import benchmarks
    from hcunet_tpu_torch.config import RUNetConfig, UNetConfig

    made = {"production_3d U-Net": lambda: benchmarks._init_unet(UNetConfig.production_3d()),
            "RecursiveUNet": lambda: benchmarks._init_runet(RUNetConfig(timesteps=10)),
            "ResNet50-FPN detector": lambda: benchmarks._init_detector(dev)}
    secs = {}
    for name, make in made.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        make().to(dev)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
    print("bench seeded inits, each moved to the card: "
          + ", ".join(f"{n} {s:.3f} s" for n, s in secs.items()), flush=True)


def bench_pipeline(dev, kernel) -> int:
    """The pipeline metric in this process on the ``cli`` phase's scene,
    its soft deadline ``BENCH_PIPELINE_DEADLINE_S`` away: the fit, the
    bf16 detector, a warm-up and as many reps as the deadline leaves.
    Every ``analyze`` call must launch K1 15 times per tile batch of every
    chunk (14 ring, 1 basic); prints the bf16 detector's candidates and the
    cells of the last call.  Returns K1's launches over the metric (counts
    set to 0 just before it)."""
    import hcunet_tpu_torch.infer.pipeline as pipeline
    from hcunet_tpu_torch import benchmarks
    from hcunet_tpu_torch.config import UNetConfig, auto_tile_config, device_hbm_bytes

    scene = benchmarks._blob_scene(*CLI_SCENE, CLI_CELLS, seed=SEED)
    tiles = auto_tile_config(UNetConfig.production_3d(), hbm_bytes=device_hbm_bytes(dev))
    n = 3  # the metric's numchunks: (n - 1)^2 chunks
    edges = np.linspace(0, CLI_SCENE[0], n).astype(int)
    chunk = (int(edges[1] - edges[0]), int(edges[1] - edges[0]), CLI_SCENE[2])
    batches = unet_tile_batches(chunk, tiles) * (n - 1) ** 2
    want = {"basic": batches, "ring": 14 * batches}
    calls = []
    inner = pipeline.analyze

    def counted(*args, **kwargs):
        before = dict(kernel.route_launches)
        res = inner(*args, **kwargs)
        calls.append(({r: k - before[r] for r, k in kernel.route_launches.items()},
                      len(res.cells), sorted(res.stage_seconds)))
        return res

    log = ChunkLog()
    logging.getLogger("hcunet_tpu_torch.infer.pipeline").addHandler(log)
    pipeline.analyze = counted
    torch.cuda.synchronize()
    reset_counts([kernel])
    t0 = time.perf_counter()
    try:
        rec = benchmarks.pipeline_metric(dev, scene, deadline=time.monotonic()
                                         + BENCH_PIPELINE_DEADLINE_S)
    finally:
        pipeline.analyze = inner
        logging.getLogger("hcunet_tpu_torch.infer.pipeline").removeHandler(log)
    secs = time.perf_counter() - t0
    launches = kernel.launches
    candidates = sum(c.get("candidates", 0) for c in log.counts.values())
    print(f"bench pipeline metric on {CLI_SCENE} ({CLI_CELLS} cells, the fit, the bf16 "
          f"detector, {(n - 1) ** 2} chunks of {chunk}, {tiles}) in {secs:.1f} s: "
          f"{json.dumps(rec)}; analyze calls (warm-up first): K1 by path "
          f"{[c[0] for c in calls]} (expected {want} each), cells {[c[1] for c in calls]}; "
          f"the last call's bf16 detector candidates {candidates} "
          f"{ {k: v.get('candidates') for k, v in sorted(log.counts.items())} }; "
          f"K1 over the metric {launches}", flush=True)
    check_bench_record(rec, {"metric", "value", "unit", "vs_baseline", "reps", "stage_seconds",
                             "transfer_mb"})
    if len(calls) != rec["reps"] + 1 or any(c[0] != want for c in calls):
        raise AssertionError(f"bench analyze calls launched K1 {[c[0] for c in calls]}, "
                             f"expected {rec['reps'] + 1} calls of {want}")
    stages = ["analytics", "detect", "instance", "unet"]
    if any(c[2] != stages for c in calls) or sorted(rec["stage_seconds"]) != stages:
        raise AssertionError(f"bench stage seconds {rec['stage_seconds']}, expected {stages}")
    if not candidates:
        raise AssertionError("the bf16 detector found no candidate")
    return launches


def bench_phase(dev, kernel) -> int:
    """The benchmark module on the card: the command line's ``bench
    --headline --recurrent`` at full size (a subprocess), the seeded inits,
    and the pipeline metric in this process at the ``cli`` phase's scene.
    Returns K1's launches over the in-process metric."""
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_bench_")
    old = os.environ.get("HCUNET_CACHE_DIR")
    try:
        torch.cuda.empty_cache()
        bench_cli(os.path.join(root, "cli"))
        t1 = time.perf_counter()
        bench_inits(dev)
        # the fit's cache in a fresh directory: the metric fits, as a first run does
        os.environ["HCUNET_CACHE_DIR"] = os.path.join(root, "inproc")
        launches = bench_pipeline(dev, kernel)
    finally:
        if old is None:
            os.environ.pop("HCUNET_CACHE_DIR", None)
        else:
            os.environ["HCUNET_CACHE_DIR"] = old
        shutil.rmtree(root, ignore_errors=True)
    t2 = time.perf_counter()
    print(f"bench phase: {t2 - t0:.1f} s (command line {t1 - t0:.1f}, inits and the "
          f"pipeline metric {t2 - t1:.1f})", flush=True)
    return launches


PHASES = {
    "k1": ("K1",),
    "k3": ("K3",),
    "slice1": ("K1", "TCONV"),
    "tconv": ("K1", "TCONV"),
    "k2": ("K2",),
    "slice2": ("K1", "K2"),
    "blobs": ("K2",),
    "train": ("K1",),
    "slice3": ("K1", "K2", "host"),
    "cli": ("K1", "host", "TCONV"),
    "recurrent": ("K1",),
    "rtrain": ("K1",),
    "dtrain": ("TCONV",),
    "mesh": ("K1", "TCONV"),
    "hcat": ("K1",),
    "bench": ("K1",),
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
    from hcunet_tpu_torch.ops.conv import CONV3D_VALID, CONV3D_VALID_INPUT_GRAD
    from hcunet_tpu_torch.ops.distance import EDT_PASS
    from hcunet_tpu_torch.ops.dot import DOT_BLOCKED
    from hcunet_tpu_torch.ops.tconv import TCONV3D_SUBPIXEL
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
    builds = {**kernels, "TCONV": TCONV3D_SUBPIXEL}
    needed = {k for p in phases for k in PHASES[p]}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        host = pool.submit(WATERSHED_HOST.load) if "host" in needed else None
        build_all(k for name, k in builds.items() if name in needed)
        if host is not None:
            host.result()
    built = [f"{name} {k.build_seconds:.1f} s" for name, k in builds.items() if name in needed]
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
    # the transposed-conv kernel's launches in each phase, its count set to
    # 0 at the phase's start
    tconv_by_phase = {}
    reset_counts([TCONV3D_SUBPIXEL])

    def phase_done(phase, label):
        marks.append((label, time.perf_counter()))
        tconv_by_phase[phase] = TCONV3D_SUBPIXEL.launches
        reset_counts([TCONV3D_SUBPIXEL])

    layers = record_layers(seg.model, seg.tile_cfg, dev) if {"k1", "k3"} & set(phases) else []
    # phase 3: K1 against its plain version at the main path's shapes
    if "k1" in phases:
        rows = k1_phase(layers, gen, dev)
        phase_done("k1", "K1 checks")
    # phase 4: K3 against its plain version, and beside K1
    if "k3" in phases:
        k3_rows = dot_phase([gemm_shape(x_shape, w) for x_shape, w, _b, _r in layers], rows, dev)
        phase_done("k3", "K3 checks")
    del layers
    # phase 5: slice 1's path
    if "slice1" in phases:
        total = slice1_phase(model, seg, dev, CONV3D_VALID)
        phase_done("slice1", "slice 1")
    del seg
    torch.cuda.empty_cache()
    # phase 6: the float32 transposed conv's own kernel
    tconv_rows = []
    if "tconv" in phases:
        tconv_rows = tconv_phase(model, dev)
        phase_done("tconv", "tconv")
    # phase 7: K2 against its plain version at the main path's shapes
    if "k2" in phases:
        print("K2 vs plain (exact), axes (0, 1):")
        for shape, kind in [(shape, "random") for shape in EDT_SHAPES] + EDT_STRESS:
            k2_rows.append(check_edt(shape, dev, kind))
            torch.cuda.empty_cache()
        phase_done("k2", "K2 checks")
    # phase 8: slice 2's path on the bench scene
    if "slice2" in phases:
        counts = slice2_phase(model, dev, kernels)
        torch.cuda.empty_cache()
        phase_done("slice2", "slice 2")
    # phase 9: the instance stage with K2 against the plain EDT
    if "blobs" in phases:
        check_instance_stage(dev)
        torch.cuda.empty_cache()
        phase_done("blobs", "instance blobs")
    # phase 10: training, and the fitted weights for slice 3 and the command line
    grad_rows = []
    train_counts = {"forward": 0, "input_grad": 0}
    if "train" in phases:
        model, train_counts, grad_rows = train_phase(dev)
        torch.cuda.empty_cache()
        phase_done("train", "train")
    # phase 11: slice 3's path, analyze on the pipeline scene
    if "slice3" in phases:
        counts3 = analyze_phase(model, dev, kernels)
        phase_done("slice3", "slice 3")
    # phase 12: the user entry points (command line, batch, facade)
    cli_launches = 0
    cli_analyze = {}
    if "cli" in phases:
        cli_launches = cli_phase(model, dev, CONV3D_VALID, keep=cli_analyze)
        phase_done("cli", "cli")
    # phase 13: the recurrent family's serving
    rec_launches = 0
    if "recurrent" in phases:
        rec_rows, rec_launches = recurrent_phase(dev, CONV3D_VALID)
        rows += rec_rows
        torch.cuda.empty_cache()
        phase_done("recurrent", "recurrent")

    # phase 14: recurrent training
    rtrain_rows = []
    rtrain_counts = {"forward": 0, "input_grad": 0}
    if "rtrain" in phases:
        rtrain_rows, rtrain_counts = rtrain_phase(dev, (CONV3D_VALID, CONV3D_VALID_INPUT_GRAD))
        torch.cuda.empty_cache()
        phase_done("rtrain", "rtrain")
    # phase 15: detection training (no kernel on its path)
    if "dtrain" in phases:
        dtrain_phase(model, dev)
        torch.cuda.empty_cache()
        phase_done("dtrain", "dtrain")
    # phase 16: the multi-device paths over a mesh of the card(s)
    mesh_counts = {"forward": 0, "input_grad": 0}
    if "mesh" in phases:
        mesh_counts = mesh_phase(model, dev, (CONV3D_VALID, CONV3D_VALID_INPUT_GRAD),
                                 cli_analyze)
        torch.cuda.empty_cache()
        phase_done("mesh", "mesh")
    # phase 17: the reference's driver surface (hcunet_tpu_torch.hcat)
    hcat_launches = 0
    if "hcat" in phases:
        hcat_launches = hcat_phase(dev, CONV3D_VALID)
        torch.cuda.empty_cache()
        phase_done("hcat", "hcat")

    # phase 18: the benchmark module (the bench command line and metrics)
    bench_launches = 0
    if "bench" in phases:
        bench_launches = bench_phase(dev, CONV3D_VALID)
        torch.cuda.empty_cache()
        phase_done("bench", "bench")

    # phase 19: results.  A kernel's launches are those of the whole main
    # path (slices 1-3, training, the command line, the
    # recurrent family's serving and training, detection training's
    # analyze, the mesh paths, the hcat driver surface and the in-process
    # bench metric), not of the check phases:
    # a run of fewer phases gives none, and ends with a line that says which
    # phases ran in place of the result line.
    full = phases == list(PHASES)
    tconv_paths = {p: tconv_by_phase.get(p, 0) for p in PHASES
                   if p not in ("k1", "k3", "tconv", "k2", "blobs")}
    for row in tconv_rows:
        row["launches"] = sum(tconv_paths.values()) if full else None
        row["launches_by_path"] = tconv_paths if full else None
    for kernel_rows, name in ((rows, "K1"), (k2_rows, "K2"), (k3_rows, "K3")):
        k1 = name == "K1"
        by_path = {"slice1": total if k1 else 0,
                   "slice2": counts[name], "slice3": counts3[name],
                   "train": train_counts["forward"] if k1 else 0,
                   "cli": cli_launches if k1 else 0,
                   "recurrent": rec_launches if k1 else 0,
                   "rtrain": rtrain_counts["forward"] if k1 else 0,
                   "mesh": mesh_counts["forward"] if k1 else 0,
                   "hcat": hcat_launches if k1 else 0,
                   "bench": bench_launches if k1 else 0}
        for row in kernel_rows:
            row["launches"] = sum(by_path.values()) if full else None
            row["launches_by_path"] = by_path if full else None
    grad_by_path = {"train": train_counts["input_grad"], "rtrain": rtrain_counts["input_grad"],
                    "mesh": mesh_counts["input_grad"]}
    for row in grad_rows + rtrain_rows:
        row["launches"] = sum(grad_by_path.values()) if full else None
        row["launches_by_path"] = grad_by_path if full else None
    paths = {"slice1": f"slice 1 {total} K1",
             "slice2": f"slice 2 {counts['K1']} K1, {counts['K2']} K2 and {counts['K3']} K3",
             "train": f"training {train_counts['forward']} K1 forward and "
                      f"{train_counts['input_grad']} K1 input-gradient",
             "slice3": f"slice 3 {counts3['K1']} K1, {counts3['K2']} K2 and {counts3['K3']} K3",
             "cli": f"the command line's analyze {cli_launches} K1",
             "recurrent": f"the recurrent forwards and predict-recurrent {rec_launches} K1",
             "rtrain": f"recurrent training {rtrain_counts['forward']} K1 forward and "
                       f"{rtrain_counts['input_grad']} K1 input-gradient",
             "dtrain": "detection training no kernel",
             "mesh": f"the mesh paths {mesh_counts['forward']} K1 forward and "
                     f"{mesh_counts['input_grad']} K1 input-gradient",
             "hcat": f"the hcat driver surface {hcat_launches} K1",
             "bench": f"the in-process bench pipeline metric {bench_launches} K1"}
    tconv_ran = {p: n for p, n in tconv_paths.items() if p in phases}
    print(
        "main path launches: " + ("; ".join(v for k, v in paths.items() if k in phases) or "none")
        + "; the float32 transposed-conv kernel "
        + (", ".join(f"{p} {n}" for p, n in tconv_ran.items()) or "none")
        + f"; total {time.perf_counter() - t_start:.1f} s; phase seconds "
        + ", ".join(f"{name} {t - t0:.1f}" for (_n, t0), (name, t) in zip(marks, marks[1:])),
        flush=True,
    )
    rows += grad_rows + rtrain_rows + k2_rows + k3_rows + tconv_rows
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
