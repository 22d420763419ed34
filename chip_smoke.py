#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``hcunet_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU and the CUDA
toolkit::

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. print the card (``nvidia-smi`` name and power limit) and turn TF32 off;
2. build kernel K1 (``hcunet_tpu_torch/csrc/conv3d_valid.cu``) into ``build/``;
3. hold K1 against its plain version at the 15 valid-conv shapes of the
   production U-Net's serving forward at the tile geometry the port picks
   for this card, plus the TPU probe's case 1, in bfloat16 and float32,
   timing the kernel, the plain version and cuDNN's ``F.conv3d``;
4. the main path: ``Segmenter.predict`` on ``UNetConfig.production_3d()``
   at full width (random He-normal weights and random batch-norm statistics
   from a seed) for three requests, checking that every tile batch launched
   K1 15 times, and that the float32 request agrees with a forward built on
   the plain conv;
5. print one JSON line of kernel rows, the card line, and the result line.

Imports only ``hcunet_tpu_torch``, torch and numpy.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

H100_BF16_FLOPS = 989e12  # dense tensor-core peak, H100 SXM data sheet
H100_F32_FLOPS = 67e12    # float32 outside the tensor cores (TF32 is off)
H100_BYTES_PER_S = 3.35e12
SEED = 0
REQUESTS = [(1152, 1152, 15), (1000, 900, 15), (2304, 2304, 15)]
PROBE_CASE_1 = ((6, 494, 494, 3, 128), (3, 3, 2, 128, 128))
LAYER_NAMES = (
    [f"down{i}.conv{j}" for i in range(4) for j in (1, 2)]
    + [f"up{i}.conv{j}" for i in range(3) for j in (1, 2)]
    + ["out_conv"]
)


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


def check_kernel(name, x_shape, w, b, relu, dtype, gen, dev):
    """K1 against its plain version on one shape and dtype; returns a row."""
    from hcunet_tpu_torch.ops.conv import conv3d_valid, conv3d_valid_plain

    x = torch.randn(x_shape, generator=gen, device=dev).to(dtype)
    w = w.to(dtype).contiguous()
    got = conv3d_valid(x, w, b, relu)
    want = conv3d_valid_plain(x, w, b, relu)
    torch.cuda.synchronize()
    scale = max(1.0, float(want.float().abs().max()))
    # float32: both sum in float32 in different orders.  bfloat16: both round
    # the float32 sum once, so they differ by at most one bf16 ulp (2^-7
    # relative) where the sums straddle a rounding boundary.
    tol = 1e-5 * scale if dtype == torch.float32 else 2.0**-7 * scale
    err = float((got.float() - want.float()).abs().max())
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
        f"  {row['name']:34s} x{list(x_shape)} w{list(w.shape)} err {err:.3e} "
        f"(tol {tol:.3e}) kernel {kernel_ms:8.3f} ms plain {plain_ms:8.3f} ms "
        f"cudnn {library_ms:8.3f} ms bound {row['bound_ms']:7.3f} ms "
        f"({row['bound_by']}, {flops / kernel_ms / 1e9:.1f} TFLOP/s)",
        flush=True,
    )
    if not err <= tol:
        raise AssertionError(f"{row['name']}: max error {err} > tolerance {tol}")
    return row


def n_tile_batches(seg, spatial) -> int:
    bucket = seg.bucket_shape(spatial)
    ev = [min(e, s) for e, s in zip(seg.tile_cfg.eval_size, bucket)]
    tiles = math.prod(-(-s // e) for s, e in zip(bucket, ev))
    return -(-tiles // seg.tile_cfg.batch)


def run_request(seg, vol, kernel) -> tuple[np.ndarray, float, int, int]:
    """One ``predict`` with the launch count set to 0 just before it.
    Returns the probabilities, seconds, launches and peak device bytes."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel.launches = 0
    t0 = time.perf_counter()
    out = seg.predict(vol)
    sec = time.perf_counter() - t0
    launches = kernel.launches
    peak = torch.cuda.max_memory_allocated()
    want = 15 * n_tile_batches(seg, vol.shape[:-1])
    if launches != want:
        raise AssertionError(f"K1 launched {launches} times, expected {want}")
    if out.shape != vol.shape[:-1] or not np.isfinite(out).all():
        raise AssertionError(f"bad output {out.shape} for {vol.shape}")
    if out.min() < 0 or out.max() > 1:
        raise AssertionError(f"probabilities outside [0, 1]: {out.min()} {out.max()}")
    return out, sec, launches, peak


def profile_request(seg, vol) -> None:
    """One more ``predict`` under ``torch.profiler``: device time by kernel
    and the device's busy share of the request's wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        seg.predict(vol)
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
        print("profile: device time not measured (the profiler saw no device events)")
        return
    k1 = sum(r[0] for r in rows if "conv3d_valid_kernel" in r[2])
    print(
        f"profile of request {vol.shape[:-1]}: wall {wall_us / 1e3:.1f} ms, device busy "
        f"{busy / 1e3:.1f} ms ({100 * busy / wall_us:.1f}%, idle "
        f"{100 * (1 - busy / wall_us):.1f}%), K1 {k1 / 1e3:.1f} ms "
        f"({100 * k1 / busy:.1f}% of device time)"
    )
    for us, count, key in sorted(rows, reverse=True)[:12]:
        print(f"  {us / 1e3:9.2f} ms {count:5d}x  {key[:110]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not (Path(__file__).resolve().parent / "hcunet_tpu_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 1
    from hcunet_tpu_torch.config import UNetConfig
    from hcunet_tpu_torch.infer.compile import compile_serving_apply
    from hcunet_tpu_torch.infer.serving import Segmenter
    from hcunet_tpu_torch.infer.tiling import predict_segmentation_mask
    from hcunet_tpu_torch.ops.conv import CONV3D_VALID, conv3d_valid_plain

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    # phase 1: the card
    card = card_line()
    print(f"card: {card}; torch.cuda.get_device_name: {torch.cuda.get_device_name(0)}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(
        f"TF32: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}"
    )

    # phase 2: build K1
    CONV3D_VALID.function()
    print(f"K1 built by nvcc for sm_90a in {CONV3D_VALID.build_seconds:.1f} s")

    # phase 3: K1 against its plain version at the main path's shapes
    cfg = UNetConfig.production_3d()
    gen = torch.Generator().manual_seed(SEED)
    model = build_model(cfg, gen)
    seg = Segmenter(model, dtype=torch.bfloat16, device=dev)
    tile_cfg = seg.tile_cfg
    print(f"tile geometry: {tile_cfg}")
    layers = record_layers(seg.model, tile_cfg, dev)
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
            rows.append(check_kernel(name, x_shape, w, b, relu, dtype, gen_dev, dev))
            torch.cuda.empty_cache()
    del layers, cases

    # phase 4: the main path
    rng = np.random.default_rng(SEED)
    vols = [rng.random((*sp, cfg.in_channels), dtype=np.float32) for sp in REQUESTS]
    seg.warmup([REQUESTS[0]])
    total = 0
    for sp, vol in zip(REQUESTS, vols):
        out, sec, n, peak = run_request(seg, vol, CONV3D_VALID)
        total += n
        print(
            f"request {sp}: {sec:.3f} s, {math.prod(sp) / sec / 1e6:.2f} MVx/s, "
            f"{n} K1 launches = 15 x {n // 15} tile batches, peak device memory "
            f"{peak / 2**30:.2f} GiB, p in [{out.min():.4f}, {out.max():.4f}]",
            flush=True,
        )
        if sp == REQUESTS[0]:
            p_bf16 = out

    seg32 = Segmenter(model, dtype=torch.float32, device=dev, tile_cfg=tile_cfg)
    p_k, sec, n, _ = run_request(seg32, vols[0], CONV3D_VALID)
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
    profile_request(seg, vols[-1])

    # phase 5: results
    for row in rows:
        row["launches"] = total
    print(f"main path: {total} K1 launches; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
