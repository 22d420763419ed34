"""Command-line interface of the PyTorch port (twin of ``hcunet_tpu/cli.py``).

    python -m hcunet_tpu_torch.cli <command> ...     (or the script hcunet-torch)

Subcommands:

    analyze      one z-stack end-to-end (checkpointed U-Net + detector)
    batch        walk a data root, analyze every tif (manifest-resumable)
    train-unet   train the valid-conv U-Net on Stack triplets
    preprocess   build COM/vector training targets from label masks
    validate     dice / pixel-error validation on a Stack dataset
    study        aggregate per-cell stats across analyzed images (+figures)
    predict-recurrent  a recurrent checkpoint's raw head over z-stacks

Each parser takes the JAX command's arguments with its defaults; the JAX
command's ``train-rcnn``, ``train-recurrent``, ``pretrain-backbone`` and
``bench`` wait for their back ends.  The
commands that run a model also take ``--device`` (default ``cuda``; ``cpu``
runs the plain versions of the kernels on the host): there is no fallback
to the CPU when the card is missing.  Checkpoints are the JAX package's zip
format, so a checkpoint written by either command line loads in the other.
The U-Net serves in its checkpoint's dtype, float32, and
``predict-recurrent`` in bfloat16 through ``compile_recurrent_apply``, as
the JAX commands do.  Multi-device runs (``--spatial-shards``, ``--data-parallel`` above
1) are not ported yet and exit with a message.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda; cpu runs the "
                        "kernels' plain versions on the host)")


def _add_analyze(sub):
    p = sub.add_parser("analyze", help="analyze one cochlea z-stack")
    p.add_argument("image")
    p.add_argument("--unet", required=True, help=".hcunet checkpoint")
    p.add_argument("--detector", default=None, help="detector checkpoint (optional)")
    p.add_argument("--out", default=None, help="work/output dir")
    p.add_argument("--numchunks", type=int, default=3)
    p.add_argument("--no-cochlea", action="store_true")
    p.add_argument("--trace", default=None,
                   help="capture a torch.profiler trace into this directory")
    p.add_argument("--spatial-shards", type=int, default=1,
                   help="shard each chunk's X axis over this many devices "
                        "(not ported yet: values above 1 exit)")
    _add_transfer_flags(p)
    _add_device(p)


def _add_transfer_flags(p):
    p.add_argument("--prob-dtype", default="float32",
                   choices=("float32", "uint16", "bfloat16"),
                   help="device->host dtype for the probability map: "
                        "float32 = exact (default); uint16 = fixed-point, "
                        "2 B/voxel at <=7.6e-5 max error")
    p.add_argument("--tail-workers", type=int, default=1,
                   help="concurrent host-side chunk tails (detection "
                        "collect + instance watershed); >1 keeps floods "
                        "from consecutive chunks running while the device "
                        "works; output is order-preserved and identical")


def _add_batch(sub):
    p = sub.add_parser("batch", help="analyze every tif under a root")
    p.add_argument("data_root")
    p.add_argument("--unet", required=True)
    p.add_argument("--detector", default=None)
    p.add_argument("--numchunks", type=int, default=6)
    p.add_argument("--retry-errors", action="store_true")
    p.add_argument("--spatial-shards", type=int, default=1,
                   help="shard each chunk's X axis over this many devices "
                        "(not ported yet: values above 1 exit)")
    _add_transfer_flags(p)
    _add_device(p)


def _add_train_unet(sub):
    p = sub.add_parser("train-unet", help="train the 3D U-Net")
    p.add_argument("data", help="directory of X.tif / X.mask.tif / X.pwl.tif "
                                "(or .npy)")
    p.add_argument("--out", default="unet.hcunet")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--crop", type=int, nargs=3, default=[128, 128, 24])
    p.add_argument("--loss-method", default="pixel",
                   choices=["pixel", "worst_z", "sigmoid"])
    p.add_argument("--data-parallel", type=int, default=1,
                   help="shard each train batch over this many devices "
                        "(not ported yet: values above 1 exit)")
    _add_device(p)


def _add_preprocess(sub):
    p = sub.add_parser("preprocess", help="build training targets")
    p.add_argument("data", help="directory of *.labels.tif color masks")
    p.add_argument("--workers", type=int, default=os.cpu_count() or 1)


def _add_validate(sub):
    p = sub.add_parser(
        "validate", help="dice / pixel-error validation on a Stack dataset"
    )
    p.add_argument("data", help="directory of X.tif / X.mask.tif / X.pwl.tif")
    p.add_argument("--unet", required=True)
    p.add_argument("--threshold", type=float, default=0.5)
    _add_device(p)


def _add_study(sub):
    p = sub.add_parser(
        "study",
        help="aggregate per-cell stats across analyzed images, with the "
        "study boxplot/regression figures (needs pandas and matplotlib)",
    )
    p.add_argument(
        "dirs", nargs="+",
        help="analyzed work dirs (chunk .cells.npz journals) or legacy "
        "all_cells.pkl files; experiment metadata is parsed from the "
        "directory names",
    )
    p.add_argument("--out", default="study_out")
    p.add_argument("--group-by", default="promoter")


def _add_predict_recurrent(sub):
    p = sub.add_parser(
        "predict-recurrent",
        help="run a recurrent checkpoint over z-stacks through the recurrent "
        "serving forward; writes the raw head stack [X, Y, Z, out_channels] as "
        ".npy (sigmoid channel 0 for the probability map)",
    )
    p.add_argument("images", nargs="+", help="tif/npy z-stacks; same-shaped "
                   "stacks are batched per dispatch")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--out-dir", default=".",
                   help="writes <stem>.recurrent.npy per input")
    p.add_argument("--no-packed", action="store_true",
                   help="bypass the serving forward: the model's plain float32 "
                        "forward")
    p.add_argument("--split-x", type=int, nargs="?", const=4, default=0,
                   metavar="N",
                   help="single-volume latency mode: run each volume as N "
                        "(default 4) overlapping x-tiles batched on the "
                        "leading axis with per-timestep halo exchange")
    _add_device(p)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="hcunet-torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)
    _add_analyze(sub)
    _add_batch(sub)
    _add_train_unet(sub)
    _add_preprocess(sub)
    _add_validate(sub)
    _add_study(sub)
    _add_predict_recurrent(sub)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    for flag in ("spatial_shards", "data_parallel"):
        n = getattr(args, flag, 1)
        if n > 1:
            raise SystemExit(
                f"--{flag.replace('_', '-')} {n}: multi-device runs are not ported "
                f"to hcunet_tpu_torch yet; run on one device"
            )
    commands = {
        "analyze": _cmd_analyze_like,
        "batch": _cmd_analyze_like,
        "train-unet": _cmd_train_unet,
        "preprocess": _cmd_preprocess,
        "validate": _cmd_validate,
        "study": _cmd_study,
        "predict-recurrent": _cmd_predict_recurrent,
    }
    return commands[args.cmd](args)


def _load_models(unet_path, detector_path, device):
    """The U-Net's serving forward and the detector, both on ``device``.

    The U-Net serves in its checkpoint's dtype (float32), through
    ``compile_serving_apply``, as the JAX command line does."""
    from hcunet_tpu_torch.infer.compile import compile_serving_apply
    from hcunet_tpu_torch.utils.checkpoint import load_model, load_unet

    model, _variables, _ = load_unet(unet_path)
    unet_apply = compile_serving_apply(model, dtype=model.dtype, device=device)
    detector = None
    if detector_path:
        detector, _vars, _ = load_model(detector_path, device=device)
    return model, unet_apply, detector


def _cmd_analyze_like(args):
    from hcunet_tpu_torch.config import PipelineConfig
    from hcunet_tpu_torch.infer.pipeline import analyze

    model, unet_apply, detector = _load_models(args.unet, args.detector, args.device)
    cfg = PipelineConfig(
        numchunks=args.numchunks, unet=model.config,
        prob_transfer_dtype=args.prob_dtype,
    )
    tail_workers = max(0, int(args.tail_workers))

    if args.cmd == "analyze":
        out = args.out or os.path.splitext(args.image)[0] + "_cellBycell"
        ctx = contextlib.nullcontext()
        if args.trace:
            from hcunet_tpu_torch.utils.profiling import trace

            ctx = trace(args.trace)
        with ctx:
            result = analyze(
                args.image, unet_apply=unet_apply, detector=detector, cfg=cfg,
                work_dir=out, fit_cochlea=not args.no_cochlea,
                overlap=tail_workers, device=args.device,
            )
        print(json.dumps({"cells": len(result.cells), "out": out}))
        return 0

    from hcunet_tpu_torch.apps.batch import run_batch

    def one(img, out_dir):
        analyze(
            img, unet_apply=unet_apply, detector=detector, cfg=cfg,
            work_dir=out_dir, overlap=tail_workers, device=args.device,
        )

    results = run_batch(args.data_root, one, retry_errors=args.retry_errors)
    print(json.dumps(results, indent=2))
    return 0


def _cmd_train_unet(args):
    import torch

    from hcunet_tpu_torch.config import UNetConfig
    from hcunet_tpu_torch.data import transforms as t
    from hcunet_tpu_torch.data.datasets import Stack
    from hcunet_tpu_torch.models.unet import init_unet
    from hcunet_tpu_torch.train.trainer import TrainConfig, UNetTrainer

    # the canonical augment recipe (reference tests/transforms_test.py:22-39)
    ds = Stack(
        args.data,
        joint_transforms=[
            t.to_float(), t.reshape(), t.nul_crop(rate=1),
            t.random_crop(args.crop),
            t.elastic_deform(grid_shape=(4, 4, 3), scale=5),
        ],
        image_transforms=[
            t.random_gamma((0.7, 1.3)),
            t.random_intensity(range=(-15, 15)),
            t.drop_channel(0.2),
            t.spekle(0.00001),
            t.clean_image(),
            t.normalize(),
        ],
    )
    cfg = UNetConfig.production_3d()
    model = init_unet(cfg, torch.Generator().manual_seed(0))
    trainer = UNetTrainer(
        model, None,
        TrainConfig(learning_rate=args.lr, epochs=args.epochs,
                    loss_method=args.loss_method, checkpoint_path=args.out),
        device=args.device,
    )
    trainer.fit(ds)
    trainer.save(args.out)
    print(json.dumps({"checkpoint": args.out}))
    return 0


def _cmd_validate(args):
    from hcunet_tpu_torch.analysis.validate import validate_segmentation
    from hcunet_tpu_torch.data import transforms as t
    from hcunet_tpu_torch.data.datasets import Stack

    model, unet_apply, _ = _load_models(args.unet, None, args.device)
    ds = Stack(
        args.data,
        joint_transforms=[t.to_float(), t.reshape()],
        image_transforms=[t.normalize()],
    )
    results = validate_segmentation(
        unet_apply, ds, model.config, threshold=args.threshold, device=args.device
    )
    summary = [
        {k: r[k] for k in ("index", "dice", "missed_ratio", "false_ratio")}
        for r in results
    ]
    print(json.dumps(summary, indent=2))
    return 0


def _cmd_study(args):
    import glob as g

    from hcunet_tpu_torch.analysis.validate import StudyAggregate, load_legacy_cells
    from hcunet_tpu_torch.infer.pipeline import _load_cells

    agg = StudyAggregate()
    n_images = 0
    for path in args.dirs:
        if os.path.isfile(path) and path.endswith(".pkl"):
            agg.add_image(os.path.dirname(path) or path, load_legacy_cells(path))
            n_images += 1
            continue
        cells = []
        for npz in sorted(g.glob(os.path.join(path, "*.cells.npz"))):
            cells.extend(_load_cells(npz))
        if cells:
            agg.add_image(path, cells)
            n_images += 1
    if not agg.rows:
        print("no cells found", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    agg.dataframe().to_csv(os.path.join(args.out, "study.csv"), index=False)
    figures = agg.save_figures(args.out, group_by=args.group_by)
    reg = agg.gfp_vs_gain_regression()
    print(
        json.dumps(
            {
                "images": n_images,
                "cells": len(agg.rows),
                "csv": os.path.join(args.out, "study.csv"),
                "figures": figures,
                "gfp_vs_gain": reg,
            }
        )
    )
    return 0


def _cmd_predict_recurrent(args):
    import numpy as np
    import torch

    from hcunet_tpu_torch.config import RDCNetConfig, RUNetConfig
    from hcunet_tpu_torch.data.transforms import integer_unit_scale
    from hcunet_tpu_torch.infer.compile_recurrent import compile_recurrent_apply
    from hcunet_tpu_torch.infer.pipeline import _load_volume
    from hcunet_tpu_torch.utils.checkpoint import load_checkpoint, recurrent_model

    config, variables, _ = load_checkpoint(args.checkpoint)
    if not isinstance(config, (RUNetConfig, RDCNetConfig)):
        raise SystemExit(f"not a recurrent checkpoint: {type(config).__name__}")
    model = recurrent_model(config, variables, args.device)
    if args.no_packed:
        @torch.no_grad()
        def apply_fn(batch):
            return model(batch.to(args.device)).float()
    else:
        apply_fn = compile_recurrent_apply(
            model, dtype=torch.bfloat16, device=args.device, split_x=args.split_x or 1
        )

    # same-shaped stacks go in one batched dispatch, unless --split-x asks
    # for the single-volume mode, which splits only at B=1: then every
    # volume goes alone
    by_shape, vols = {}, {}
    for k, path in enumerate(args.images):
        vol = _load_volume(path)
        if np.issubdtype(vol.dtype, np.integer):
            vol = vol.astype(np.float32) / integer_unit_scale(vol.dtype)
        vols[path] = ((vol - 0.5) / 0.5).astype(np.float32)
        key = (vol.shape, k) if (args.split_x or 0) > 1 else vol.shape
        by_shape.setdefault(key, []).append(path)
    os.makedirs(args.out_dir, exist_ok=True)
    outputs = {}
    for paths in by_shape.values():
        batch = torch.from_numpy(np.stack([vols[p] for p in paths]))
        out = apply_fn(batch).cpu().numpy()
        for i, p in enumerate(paths):
            stem = os.path.splitext(os.path.basename(p))[0]
            dst = os.path.join(args.out_dir, stem + ".recurrent.npy")
            np.save(dst, out[i])
            outputs[p] = dst
    print(json.dumps({"outputs": outputs}))
    return 0


def _cmd_preprocess(args):
    import glob as g
    import multiprocessing

    from hcunet_tpu_torch.train.targets import preprocess_volume

    files = sorted(g.glob(os.path.join(args.data, "*.labels.tif")))
    if not files:
        print("no *.labels.tif found", file=sys.stderr)
        return 1
    if args.workers > 1:
        with multiprocessing.get_context("spawn").Pool(args.workers) as pool:
            pool.map(preprocess_volume, files)
    else:
        for f in files:
            preprocess_volume(f)
    print(json.dumps({"processed": len(files)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
