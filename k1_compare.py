#!/usr/bin/env python3
"""Kernel K1, K2 or K3 against another build of its source, on one card, and
K1's subpixel route against cuDNN's transposed conv.

Run from the repository root on a machine with an NVIDIA GPU and the CUDA
toolkit::

    python3 k1_compare.py --other PATH/TO/OTHER/conv3d_valid.cu [--label parent]
    python3 k1_compare.py --kernel k2 --other PATH/TO/OTHER/edt_pass.cu [--label parent]
    python3 k1_compare.py --kernel k3 --other PATH/TO/OTHER/dot_blocked.cu [--label parent]
    python3 k1_compare.py --kernel k1-subpixel

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
of one tile batch (``chip_smoke.dot_cases``), in bfloat16, on the inputs of
``chip_smoke.dot_inputs``, the other build (held to the plain version),
then ``chip_smoke.check_dot`` (this K3 on the path it must take against the
plain version, its time, ``torch.matmul``'s and the bound), then the other
build again; its time is the mean of the two.  Prints the cases, the sums
over the layer GEMMs, the card line and a JSON line of the rows.

K1's subpixel route (``--kernel k1-subpixel``, no ``--other``): at the
three up levels of one bench tile batch (the serving forward of
``compile_serving_apply(subpixel_tconv=True)``, bfloat16), K1 on the
stacked parity conv through ``chip_smoke.check_kernel`` (against the plain
version, its time, cuDNN's ``conv3d`` on the same parity form and the
bound), then the whole transposed conv by the subpixel route (pad, K1,
interleave) and by cuDNN's ``conv_transpose3d``, in turns
(``chip_smoke.time_tconv_routes``).  Prints the levels, the sums, the card
line and a JSON line of the rows.
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
    from hcunet_tpu_torch.ops.dot import DOT_BLOCKED, dot_blocked_plain

    other_k3 = CudaKernel(str(args.other.resolve()), DOT_BLOCKED.symbol, DOT_BLOCKED.argtypes)
    build_all([DOT_BLOCKED, other_k3])

    def other(x, w):
        """The other build's dot_blocked in bfloat16, called as the port's
        wrapper calls it."""
        K, N = w.shape
        y = torch.empty((*x.shape[:-1], N), device=dev, dtype=x.dtype)
        rc = other_k3.function()(
            1, x.data_ptr(), w.data_ptr(), y.data_ptr(), y.numel() // N, K, N,
            torch.cuda.current_stream().cuda_stream,
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
    print(f"card: {card}; K3 ({DOT_BLOCKED.source}) vs {args.label} ({args.other}), bf16")
    for name, x_shape, n, pieces, route in cs.dot_cases(gemms, torch.bfloat16):
        x, w = cs.dot_inputs(x_shape, n, torch.bfloat16, dev)
        parts = [x] if pieces is None else [x[:, :, :p] for p in pieces]
        err, tol = cs.kernel_error(other(x, w), dot_blocked_plain(x, w))
        if not err <= tol:
            raise AssertionError(f"{name}: {args.label} max error {err} > {tol}")
        t_other = cs.cuda_ms(lambda: [other(p, w) for p in parts])
        row = cs.check_dot(name, x_shape, n, torch.bfloat16, dev, pieces, route)
        row[key] = (t_other + cs.cuda_ms(lambda: [other(p, w) for p in parts])) / 2
        row[f"{args.label}_max_abs_err"] = err
        rows.append(row)
        print(f"  {'':34s} {args.label} {row[key]:8.3f} ms, err {err:.3e}; "
              f"this/{args.label} {row['ms'] / row[key]:.3f}, this/matmul "
              f"{row['ms'] / row['library_ms']:.3f}, bound/this {row['bound_ms'] / row['ms']:.3f}",
              flush=True)
        del x, w, parts
        torch.cuda.empty_cache()
    cs.dot_sums(rows, "bf16", key)
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


def compare_k1_subpixel(args, card, dev) -> None:
    from hcunet_tpu_torch.config import UNetConfig
    from hcunet_tpu_torch.csrc import build_all
    from hcunet_tpu_torch.infer.serving import Segmenter
    from hcunet_tpu_torch.ops.conv import CONV3D_VALID

    del args
    build_all([CONV3D_VALID])
    model = cs.build_model(UNetConfig.production_3d(), torch.Generator().manual_seed(cs.SEED))
    seg = Segmenter(model, dtype=torch.bfloat16, device=dev)
    parity = cs.record_parity_convs(seg.model, seg.tile_cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    print(f"card: {card}; K1 ({CONV3D_VALID.source}) on the subpixel route, {seg.tile_cfg}, bf16")
    rows = []
    for name, (x_shape, w, b, relu) in zip(cs.SUBPIXEL_LEVELS, parity):
        x = torch.randn(x_shape, generator=gen, device=dev).to(torch.bfloat16)
        rows.append(cs.check_kernel(f"subpixel_{name}", x, w, b, relu))
        del x
    for row, level in zip(rows, cs.tconv_levels(seg.model, parity, gen)):
        row["route_ms"], row["conv_transpose3d_ms"] = cs.time_tconv_routes(*level)
    sums = {k: sum(r[k] for r in rows)
            for k in ("ms", "bound_ms", "plain_ms", "library_ms", "route_ms", "conv_transpose3d_ms")}
    print("3 up levels: K1 {ms:.3f} ms (bound {bound_ms:.3f}, plain {plain_ms:.3f}, cuDNN conv3d "
          "{library_ms:.3f}); subpixel route {route_ms:.3f} ms, conv_transpose3d "
          "{conv_transpose3d_ms:.3f} ms".format(**sums))
    print(card)
    print(json.dumps({"k1_subpixel": rows}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("k1", "k2", "k3", "k1-subpixel"), default="k1",
                    help="the kernel to compare")
    ap.add_argument("--other", type=Path,
                    help="another conv3d_valid.cu (k1), edt_pass.cu (k2) or dot_blocked.cu (k3); "
                         "k1-subpixel takes none")
    ap.add_argument("--label", default="other", help="the other build's name in the output")
    args = ap.parse_args(argv)
    if (args.other is None) != (args.kernel == "k1-subpixel"):
        ap.error("--other is required for k1, k2 and k3, and k1-subpixel takes none")
    if not torch.cuda.is_available():
        print("k1_compare: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    compare = {"k1": compare_k1, "k2": compare_k2, "k3": compare_k3,
               "k1-subpixel": compare_k1_subpixel}[args.kernel]
    compare(args, cs.card_line(), dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
