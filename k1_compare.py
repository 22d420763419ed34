#!/usr/bin/env python3
"""Kernel K1, K2 or K3 against another build of its source, on one card.

Run from the repository root on a machine with an NVIDIA GPU and the CUDA
toolkit::

    python3 k1_compare.py --other PATH/TO/OTHER/conv3d_valid.cu [--label parent]
    python3 k1_compare.py --kernel k2 --other PATH/TO/OTHER/edt_pass.cu [--label parent]
    python3 k1_compare.py --kernel k3 --other PATH/TO/OTHER/dot_blocked.cu [--label parent]
    python3 k1_compare.py --kernel k1-basic --other PATH/TO/PARENT/conv3d_valid.cu [--label parent]

``--other`` is a source with the same C interface, for instance a parent
commit's copy unpacked with ``git archive``; it is built like the port's own
kernels.

K1 (the default): at the 15 valid-conv shapes of the production U-Net's
serving forward (one tile batch at the geometry the port picks for this
card; random input and the folded random weights of
``chip_smoke.build_model``), in bfloat16, each layer runs the other build
(held to the plain version with ``chip_smoke.kernel_error``), then
``chip_smoke.check_kernel`` (this K1 against the plain version, its time,
cuDNN's and the bound), then the other build again; its time is the mean
of the two.  Then it serves the bench scene (2304 x 2304 x 15, random, seed
0) through ``Segmenter.predict`` with each build's conv in the order other,
this, this, other, host clock around each request.  Prints the layers, the
sums, the requests, the card line and a JSON line of the rows.

K2 (``--kernel k2``): at ``chip_smoke.EDT_SHAPES`` on a random mask and at
``chip_smoke.EDT_STRESS`` (a sparse background and the blob mask), the
other build's two passes (axes 0 and 1; the EDT held exactly to the plain
version), then ``chip_smoke.check_edt`` (this K2 held exactly to the plain
version, its time, the plain version's and the bound), then the other
build again; its time is the mean of the two.  Prints the shapes, the card
line and a JSON line of the rows.

K3 (``--kernel k3``): at the TPU probe's two shapes and the 15 layer GEMMs
of one tile batch (``chip_smoke.dot_cases``), in bfloat16 and then float32,
on the inputs of ``chip_smoke.dot_inputs``, the other build (held to the
plain version), then ``chip_smoke.check_dot`` (this K3 on the path it must
take against the plain version, its time, ``torch.matmul``'s and the
bound), then the other build again; its time is the mean of the two.
Prints the cases, the sums over the layer GEMMs per type, the card line
and a JSON line of the rows.

K1's basic path (``--kernel k1-basic``): ``--other`` is the
``csrc/conv3d_valid.cu`` of a checkout from before the basic path took
padding (the C signature without it); that checkout's ``ops/conv.py`` is
loaded beside the port's with its K1 set to that build, so both builds run
through their own wrappers: there a same-padding conv was K1 on an
``F.pad``-ded input, and an input gradient K1 on the output gradient padded
by d (k - 1), the whole padded input's gradient.  At the float32 tile
batch's 15 layers, the distinct convs of an ``RDCNet`` forward at 256 x 256
x 10 (bf16 and float32) and of a ``RecursiveUNet`` one (float32, all on the
basic path), and the distinct input gradients of one training step of each
family at 128 x 128 x 10 (bf16 and float32): the other build's call (held
to the plain version with ``chip_smoke.kernel_error``), then
``chip_smoke.check_kernel`` or ``chip_smoke.check_input_grad`` (this K1
alone against the plain version, its time, cuDNN's and the bound), then
each build's whole call in the order other, this, this, other, twice:
timed by the events around the calls (as a caller sees them: the host's
pace where it is the slower), and enqueued behind a sleep kernel, which
parts the device time from the host's (``queued_ms``).  Each time is the
mean of its two.  The other build's pads are timed apart as well (they are
inside its calls, as the ring path's are inside this build's).  Prints the
rows, the sums per group (weighted by the calls of one forward or step),
the card line and a JSON line of the rows.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs


def compare_k1(args, card, dev) -> None:
    from hcunet_tpu_torch.config import UNetConfig
    from hcunet_tpu_torch.csrc import CudaKernel, build_all
    from hcunet_tpu_torch.infer.compile import compile_serving_apply
    from hcunet_tpu_torch.infer.serving import Segmenter
    from hcunet_tpu_torch.ops.conv import CONV3D_VALID, conv3d_valid_plain

    other_k1 = CudaKernel(str(args.other.resolve()), CONV3D_VALID.symbol, CONV3D_VALID.argtypes)
    build_all([CONV3D_VALID, other_k1])

    def other(x, w, b, relu):
        """The other build's conv3d_valid, called as the port's wrapper
        calls it for a bfloat16, undilated conv."""
        B, X, Y, Z, cin = x.shape
        kx, ky, kz, _, cout = w.shape
        y = torch.empty((B, X - kx + 1, Y - ky + 1, Z - kz + 1, cout), device=dev, dtype=x.dtype)
        rc = other_k1.function()(
            1, x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), B, X, Y, Z, cin,
            kx, ky, kz, 1, 1, 1, cout, int(relu), torch.cuda.current_stream().cuda_stream,
        )
        if rc != 0:
            raise RuntimeError(f"{args.label} conv3d_valid failed: CUDA error {rc}")
        return y

    model = cs.build_model(UNetConfig.production_3d(), torch.Generator().manual_seed(cs.SEED))
    seg = Segmenter(model, dtype=torch.bfloat16, device=dev)
    layers = cs.record_layers(seg.model, seg.tile_cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    rows = []
    print(f"card: {card}; K1 ({CONV3D_VALID.source}) vs {args.label} ({args.other}), bf16")
    for name, (x_shape, w, b, relu) in zip(cs.LAYER_NAMES, layers):
        x = torch.randn(x_shape, generator=gen, device=dev).to(torch.bfloat16)
        w = w.to(torch.bfloat16).contiguous()
        err, tol = cs.kernel_error(other(x, w, b, relu), conv3d_valid_plain(x, w, b, relu))
        if not err <= tol:
            raise AssertionError(f"{name}: {args.label} max error {err} > {tol}")
        t_other = cs.cuda_ms(lambda: other(x, w, b, relu))
        row = cs.check_kernel(name, x, w, b, relu)
        row[f"{args.label}_ms"] = (t_other + cs.cuda_ms(lambda: other(x, w, b, relu))) / 2
        row[f"{args.label}_max_abs_err"] = err
        rows.append(row)
        print(f"  {'':34s} {args.label} {row[f'{args.label}_ms']:8.3f} ms, err {err:.3e}", flush=True)
        del x
        torch.cuda.empty_cache()
    cs.k1_sums(rows)
    for label, sel in (("15 layers", rows), ("ring layers", [r for r in rows if r["k1_route"] == "ring"])):
        print(f"{args.label}, {label} ({len(sel)}): {sum(r[f'{args.label}_ms'] for r in sel):.3f} ms")
    del layers
    torch.cuda.empty_cache()

    # the bench scene end to end, the serving forward on each build's conv
    vol = np.random.default_rng(cs.SEED).random((*cs.BENCH_SCENE, 4), dtype=np.float32)
    seg_other = Segmenter(model, dtype=torch.bfloat16, device=dev, tile_cfg=seg.tile_cfg)
    seg_other.apply_fn = compile_serving_apply(
        seg_other.model, dtype=torch.bfloat16, device=dev, conv=other
    )
    mvx = math.prod(cs.BENCH_SCENE) / 1e6
    seg_other.warmup([cs.BENCH_SCENE])
    seg.warmup([cs.BENCH_SCENE])
    requests = {}
    for label, server in ((args.label, seg_other), ("this", seg), ("this", seg), (args.label, seg_other)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        server.predict(vol)
        requests.setdefault(label, []).append(mvx / (time.perf_counter() - t0))
    print(f"bench scene {cs.BENCH_SCENE} predict, MVx/s: " + "; ".join(
        f"{label} {', '.join(f'{r:.2f}' for r in rs)}" for label, rs in requests.items()))
    print(card)
    print(json.dumps({"layers": rows, "bench_scene_mvx_per_s": requests}))


def compare_k3(args, card, dev) -> None:
    from hcunet_tpu_torch.csrc import CudaKernel, build_all
    from hcunet_tpu_torch.ops.dot import _KERNEL_DTYPES, DOT_BLOCKED, dot_blocked_plain

    other_k3 = CudaKernel(str(args.other.resolve()), DOT_BLOCKED.symbol, DOT_BLOCKED.argtypes)
    build_all([DOT_BLOCKED, other_k3])

    def other(x, w):
        """The other build's dot_blocked in x's dtype, called as the port's
        wrapper calls it."""
        K, N = w.shape
        y = torch.empty((*x.shape[:-1], N), device=dev, dtype=x.dtype)
        rc = other_k3.function()(
            _KERNEL_DTYPES[x.dtype], x.data_ptr(), w.data_ptr(), y.data_ptr(), y.numel() // N,
            K, N, torch.cuda.current_stream().cuda_stream,
        )
        if rc != 0:
            raise RuntimeError(f"{args.label} dot_blocked failed: CUDA error {rc}")
        return y

    from hcunet_tpu_torch.config import UNetConfig
    from hcunet_tpu_torch.infer.serving import Segmenter

    model = cs.build_model(UNetConfig.production_3d(), torch.Generator().manual_seed(cs.SEED))
    seg = Segmenter(model, dtype=torch.bfloat16, device=dev)
    gemms = [cs.gemm_shape(x_shape, w) for x_shape, w, _b, _r in
             cs.record_layers(seg.model, seg.tile_cfg, dev)]
    del seg
    torch.cuda.empty_cache()
    key = f"{args.label}_ms"
    rows = []
    for dt, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        print(f"card: {card}; K3 ({DOT_BLOCKED.source}) vs {args.label} ({args.other}), {dt}")
        for name, x_shape, n, pieces, route in cs.dot_cases(gemms, dtype):
            x, w = cs.dot_inputs(x_shape, n, dtype, dev)
            parts = [x] if pieces is None else [x[:, :, :p] for p in pieces]
            err, tol = cs.kernel_error(other(x, w), dot_blocked_plain(x, w))
            if not err <= tol:
                raise AssertionError(f"{name}: {args.label} max error {err} > {tol}")
            t_other = cs.cuda_ms(lambda: [other(p, w) for p in parts])
            row = cs.check_dot(name, x_shape, n, dtype, dev, pieces, route)
            row[key] = (t_other + cs.cuda_ms(lambda: [other(p, w) for p in parts])) / 2
            row[f"{args.label}_max_abs_err"] = err
            rows.append(row)
            print(f"  {'':34s} {args.label} {row[key]:8.3f} ms, err {err:.3e}; "
                  f"this/{args.label} {row['ms'] / row[key]:.3f}, this/matmul "
                  f"{row['ms'] / row['library_ms']:.3f}, bound/this {row['bound_ms'] / row['ms']:.3f}",
                  flush=True)
            del x, w, parts
            torch.cuda.empty_cache()
        cs.dot_sums(rows, dt, key)
    print(card)
    print(json.dumps({"k3": rows}))


def compare_k2(args, card, dev) -> None:
    from hcunet_tpu_torch.csrc import CudaKernel, build_all
    from hcunet_tpu_torch.ops.distance import EDT_PASS, _dist2, edt_plain

    other_k2 = CudaKernel(str(args.other.resolve()), EDT_PASS.symbol, EDT_PASS.argtypes)
    build_all([EDT_PASS, other_k2])

    def other_pass(d2, axis):
        """One pass of the other build's edt_pass, called as the port's
        wrapper calls it."""
        out = torch.empty_like(d2)
        n = d2.shape[axis]
        rc = other_k2.function()(
            d2.data_ptr(), out.data_ptr(), d2.numel() // n, n, math.prod(d2.shape[axis + 1:]),
            torch.cuda.current_stream().cuda_stream,
        )
        if rc != 0:
            raise RuntimeError(f"{args.label} edt_pass failed: CUDA error {rc}")
        return out

    key = f"{args.label}_ms"
    rows = []
    print(f"card: {card}; K2 ({EDT_PASS.source}) vs {args.label} ({args.other}), axes (0, 1)")
    for shape, kind in [(shape, "random") for shape in cs.EDT_SHAPES] + cs.EDT_STRESS:
        b = cs.edt_mask(shape, kind, dev)
        d2 = _dist2(b).contiguous()
        both = lambda: other_pass(other_pass(d2, 0), 1)
        got = torch.sqrt(torch.clamp(both(), max=1e12))
        if not torch.equal(got, edt_plain(b, axes=(0, 1))):
            raise AssertionError(f"{shape} ({kind}): {args.label} differs from the plain version")
        del got
        t_other = cs.cuda_ms(both)
        row = cs.check_edt(shape, dev, kind)
        row[key] = (t_other + cs.cuda_ms(both)) / 2
        rows.append(row)
        print(f"  {'':40s} {args.label} {row[key]:8.3f} ms; this/{args.label} "
              f"{row['ms'] / row[key]:.4f}, bound/this {row['bound_ms'] / row['ms']:.3f}",
              flush=True)
        del b, d2
        torch.cuda.empty_cache()
    print(card)
    print(json.dumps({"k2": rows}))


def sleep_cycles_per_ms() -> float:
    """The clock cycles of ``torch.cuda._sleep`` in one ms on this card."""
    torch.cuda._sleep(1000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    torch.cuda.synchronize()
    return 20_000_000 / start.elapsed_time(end)


def queued_ms(fn, cycles_per_ms: float, reps: int = 10) -> tuple:
    """``(device ms, host ms)`` of one ``fn()``, means over ``reps`` calls
    enqueued behind a sleep kernel after one warm-up: the events around the
    calls see only their device work, and the host clock only the time to
    enqueue them (the wrapper's Python and the launches).  The sleep is
    lengthened until it outlasts the enqueueing."""
    fn()
    stall_ms = 20.0
    while True:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(stall_ms * cycles_per_ms))
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        if host_ms < 0.5 * stall_ms:
            return start.elapsed_time(end) / reps, host_ms / reps
        stall_ms *= 4


def other_conv_module(other_cu: Path, kernel):
    """The other build's ``ops/conv.py`` (the ``ops/`` beside its
    ``csrc/``), loaded under another name with its K1 set to ``kernel``
    (a ``CudaKernel`` of ``other_cu``), so that its wrappers run as they
    ran in that build."""
    import importlib.util

    path = other_cu.resolve().parent.parent / "ops" / "conv.py"
    spec = importlib.util.spec_from_file_location("k1_compare_other_conv", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.CONV3D_VALID = kernel
    return mod


def compare_k1_basic(args, card, dev) -> None:
    import ctypes

    import torch.nn.functional as F

    from hcunet_tpu_torch.config import RDCNetConfig, RUNetConfig, UNetConfig
    from hcunet_tpu_torch.csrc import CudaKernel, build_all
    from hcunet_tpu_torch.infer.serving import Segmenter
    from hcunet_tpu_torch.models.rdcnet import RDCNet
    from hcunet_tpu_torch.models.runet import RecursiveUNet
    from hcunet_tpu_torch.ops.conv import (
        CONV3D_ROUTES,
        CONV3D_VALID,
        conv3d_valid,
        conv3d_valid_input_grad,
        conv3d_valid_plain,
    )

    P, I = ctypes.c_void_p, ctypes.c_int
    # the C signature before the padding arguments
    other_k1 = CudaKernel(str(args.other.resolve()), CONV3D_VALID.symbol,
                          [I, P, P, P, P] + [I] * 13 + [P], routes=CONV3D_ROUTES)
    build_all([CONV3D_VALID, other_k1])
    other = other_conv_module(args.other, other_k1)
    cycles = sleep_cycles_per_ms()
    lab = args.label

    def pad_of(x, pads):
        (px, py, pz) = pads
        return F.pad(x, (0, 0, pz, pz, py, py, px, px)).contiguous()

    def compare(row_fn, this_fn, other_fn, other_want, other_pad_fn):
        """Both builds' whole calls through their wrappers, in the order
        other, this, this, other, first with the events around the calls
        (what a caller sees: the host's pace where it is the slower), then
        enqueued behind a sleep (device and host apart); ``row_fn`` checks
        this K1 alone.  Returns the row."""
        err, tol = cs.kernel_error(other_fn(), other_want)
        if not err <= tol:
            raise AssertionError(f"{lab} max error {err} > {tol}")
        row = row_fn()
        t = {}
        for side, fn in ((lab, other_fn), ("this", this_fn), ("this", this_fn), (lab, other_fn)):
            t.setdefault(side, []).append(cs.cuda_ms(fn))
        q = {}
        for side, fn in ((lab, other_fn), ("this", this_fn), ("this", this_fn), (lab, other_fn)):
            q.setdefault(side, []).append(queued_ms(fn, cycles))
        for side, prefix in (("this", ""), (lab, f"{lab}_")):
            row[f"{prefix}call_ms"] = sum(t[side]) / 2
            row[f"{prefix}call_device_ms"] = sum(d for d, _h in q[side]) / 2
            row[f"{prefix}call_host_ms"] = sum(h for _d, h in q[side]) / 2
        row[f"{lab}_pad_ms"] = cs.cuda_ms(other_pad_fn) if other_pad_fn is not None else 0.0
        row[f"{lab}_max_abs_err"] = err
        print(f"  {'':34s} calls: this {row['call_ms']:.3f} ms (device {row['call_device_ms']:.3f}, "
              f"host {row['call_host_ms']:.3f}), {lab} {row[f'{lab}_call_ms']:.3f} ms (device "
              f"{row[f'{lab}_call_device_ms']:.3f}, host {row[f'{lab}_call_host_ms']:.3f}; its pads "
              f"{row[f'{lab}_pad_ms']:.3f}), this/{lab} {row['call_ms'] / row[f'{lab}_call_ms']:.3f}, "
              f"device {row['call_device_ms'] / row[f'{lab}_call_device_ms']:.3f}", flush=True)
        return row

    def forward_row(name, x, w, b, relu, dil, pad):
        padded = pad is not None and any(pad)
        # the other build's conv_same padded x with F.pad, then called K1
        return compare(
            lambda: cs.check_kernel(name, x, w, b, relu, dil, pad),
            lambda: conv3d_valid(x, w, b, relu, dil, pad or 0),
            lambda: other.conv3d_valid(pad_of(x, pad) if padded else x, w, b, relu, dil),
            conv3d_valid_plain(x, w, b, relu, dil, pad or 0),
            (lambda: pad_of(x, pad)) if padded else None,
        )

    def grad_row(name, gy, w, dil, pad):
        g = [dil * (k - 1) for k in w.shape[:3]]
        wt = w.flip((0, 1, 2)).transpose(3, 4).contiguous()
        # the other build computes the whole padded input's gradient, its
        # wrapper padding gy by d (k - 1)
        return compare(
            lambda: cs.check_input_grad(name, gy, w, dil, pad),
            lambda: conv3d_valid_input_grad(gy, w, dil, pad),
            lambda: other.conv3d_valid_input_grad(gy, w, dil),
            conv3d_valid_plain(pad_of(gy, g), wt, dilation=dil),
            lambda: pad_of(gy, g),
        )

    def sums(label, sel, weights=None):
        weights = weights or [1] * len(sel)
        keys = ("ms", "bound_ms", "plain_ms", "library_ms", "pad_ms", f"{lab}_pad_ms") + tuple(
            f"{p}call{s}_ms" for p in ("", f"{lab}_") for s in ("", "_device", "_host"))
        tot = {k: sum(w * (r.get(k) or 0.0) for w, r in zip(weights, sel)) for k in keys}
        print(f"{label} ({sum(weights)} calls): calls this {tot['call_ms']:.3f} ms (device "
              f"{tot['call_device_ms']:.3f}, host {tot['call_host_ms']:.3f}), {lab} "
              f"{tot[f'{lab}_call_ms']:.3f} ms (device {tot[f'{lab}_call_device_ms']:.3f}, host "
              f"{tot[f'{lab}_call_host_ms']:.3f}); this/{lab} "
              f"{tot['call_ms'] / tot[f'{lab}_call_ms']:.3f}, device "
              f"{tot['call_device_ms'] / tot[f'{lab}_call_device_ms']:.3f}; pads in the calls: "
              f"this {tot['pad_ms']:.3f}, {lab} {tot[f'{lab}_pad_ms']:.3f}; K1 alone "
              f"{tot['ms']:.3f} ms, bound {tot['bound_ms']:.3f} ms (K1 at "
              f"{100 * tot['bound_ms'] / tot['ms']:.1f}% of it), cuDNN {tot['library_ms']:.3f} ms "
              f"(K1/cuDNN {tot['ms'] / tot['library_ms']:.3f}), plain {tot['plain_ms']:.3f} ms",
              flush=True)
        return {"group": label, "calls": sum(weights), **tot}

    rows, groups = [], []
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    print(f"card: {card}; K1 ({CONV3D_VALID.source}) vs {args.label} ({args.other}), basic path")

    # the float32 tile batch
    model = cs.build_model(UNetConfig.production_3d(), torch.Generator().manual_seed(cs.SEED))
    seg = Segmenter(model, dtype=torch.bfloat16, device=dev)
    layers = cs.record_layers(seg.model, seg.tile_cfg, dev)
    del seg
    sel = []
    print(f"float32 tile batch, 15 layers:", flush=True)
    for name, (x_shape, w, b, relu) in zip(cs.LAYER_NAMES, layers):
        x = torch.randn(x_shape, generator=gen, device=dev)
        sel.append(forward_row(name, x, w.float().contiguous(), b, relu, 1, None))
        del x
        torch.cuda.empty_cache()
    rows += sel
    groups.append(sums("float32 tile batch, 15 layers", sel))
    del layers
    torch.cuda.empty_cache()

    # the recurrent forwards
    rgen = torch.Generator().manual_seed(cs.SEED)
    for family, net, names, dtypes in (
            ("rdcnet", RDCNet(RDCNetConfig()), cs.RDCNET_CONVS, (torch.bfloat16, torch.float32)),
            ("runet", RecursiveUNet(RUNetConfig()), cs.RUNET_CONVS, (torch.float32,))):
        net = cs.build_recurrent(net, rgen).to(dev)
        convs, _labels, calls = cs.record_recurrent_convs(net, dev, names)
        for dtype in dtypes:
            dt = "bf16" if dtype == torch.bfloat16 else "f32"
            print(f"{family} forward at {cs.RECURRENT_SCENE}, {len(convs)} distinct convs, {dt}:",
                  flush=True)
            by_key = {}
            for label, xs, w, b, relu, dil, pad in convs:
                core = [n - 2 * p for n, p in zip(xs[1:4], pad)]
                x = torch.randn((xs[0], *core, xs[4]), generator=gen, device=dev).to(dtype)
                row = forward_row(f"{family}_{label}", x, w.to(dtype).contiguous(), b, relu, dil, pad)
                by_key[(xs, tuple(w.shape), relu, dil)] = row
                rows.append(row)
                del x
            sel = [by_key[(xs, tuple(w.shape), relu, d[0])] for xs, w, _b, relu, d in calls]
            groups.append(sums(f"{family} forward {dt}", sel))
            torch.cuda.empty_cache()
        del net

    # the training steps' input gradients
    batch = cs.recurrent_scene(cs.RTRAIN_CROP, cs.SEED)["batch"]
    for family in ("runet", "rdcnet"):
        shapes, n_calls = cs.rtrain_grad_shapes(family, batch, dev)
        for dtype in (torch.bfloat16, torch.float32):
            dt = "bf16" if dtype == torch.bfloat16 else "f32"
            print(f"{family} training step input gradients, {len(shapes)} distinct, {dt}:",
                  flush=True)
            sel, weights = [], []
            for (gy_shape, w_shape, d, pad), (w, count) in shapes.items():
                gy = torch.randn(gy_shape, generator=gen, device=dev).to(dtype)
                name = f"{family} k{w_shape[0]} d{d} {w_shape[3]}->{w_shape[4]}"
                sel.append(grad_row(name, gy, w.to(dtype).contiguous(), d, pad))
                weights.append(count)
                del gy
            rows += sel
            groups.append(sums(f"{family} step input gradients {dt}", sel, weights))
            torch.cuda.empty_cache()
    print(card)
    print(json.dumps({"k1_basic": rows, "groups": groups}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("k1", "k2", "k3", "k1-basic"), default="k1",
                    help="the kernel to compare")
    ap.add_argument("--other", type=Path, required=True,
                    help="another conv3d_valid.cu (k1, k1-basic), edt_pass.cu (k2) or "
                         "dot_blocked.cu (k3)")
    ap.add_argument("--label", default="other", help="the other build's name in the output")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_compare: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    compare = {"k1": compare_k1, "k2": compare_k2, "k3": compare_k3,
               "k1-basic": compare_k1_basic}[args.kernel]
    compare(args, cs.card_line(), dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
