"""Command-line interface of the PyTorch port (twin of ``hcunet_tpu/cli.py``).

    python -m hcunet_tpu_torch.cli <command> ...     (or the script hcunet-torch)

Subcommands:

    analyze      one z-stack end-to-end (checkpointed U-Net + detector)
    batch        walk a data root, analyze every tif (manifest-resumable)
    train-unet   train the valid-conv U-Net on Stack triplets
    train-rcnn   train the detector on Section xml/tif pairs
    train-recurrent  train RecursiveUnet / RDCNet on RecursiveStack data
    predict-recurrent  a recurrent checkpoint's raw head over z-stacks
    preprocess   build COM/vector training targets from label masks
    validate     dice / pixel-error validation on a Stack dataset
    study        aggregate per-cell stats across analyzed images (+figures)
    pretrain-backbone  synthetic backbone pretraining (no-egress ImageNet sub)

Each parser takes the JAX command's arguments with its defaults; the JAX
command's ``bench`` waits for its back end.  The
commands that run a model also take ``--device`` (default ``cuda``; ``cpu``
runs the plain versions of the kernels on the host): there is no fallback
to the CPU when the card is missing.  The training commands start from
weights drawn from a seeded generator with the JAX initializers'
distributions.  Every command computes float32 in float32: ``main`` turns
TF32 off for the process (:func:`pin_float32`).  Checkpoints are the JAX package's zip
format, so a checkpoint written by either command line loads in the other.
The U-Net serves in its checkpoint's dtype, float32, and
``predict-recurrent`` in bfloat16 through ``compile_recurrent_apply``, as
the JAX commands do.  ``--spatial-shards N`` (``analyze``, ``batch``) and
``--data-parallel N`` (``train-unet``, ``train-recurrent``, ``train-rcnn``)
run over a mesh of N devices (:mod:`hcunet_tpu_torch.parallel`): with
``--device cuda`` N distinct cards, and the command exits when fewer are
present; with ``--device cpu`` N CPU entries.
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
                        "(distinct cards with --device cuda)")
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
                        "(distinct cards with --device cuda)")
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
                        "(distinct cards with --device cuda)")
    _add_device(p)


def _add_train_recurrent(sub):
    p = sub.add_parser(
        "train-recurrent",
        help="train RecursiveUnet or RDCNet (the hcat/r_unet.py recipe: "
        "pwl-BCE on the probability channel + MSE on the vector channels)",
    )
    p.add_argument("data", help="directory of X.tif / X.mask.tif / X.pwl.tif "
                                "/ X.labels.com.tif / X.labels.vector.pkl "
                                "(see `hcunet preprocess`)")
    p.add_argument("--model", default="runet", choices=["runet", "rdcnet"])
    p.add_argument("--out", default="recurrent.hcunet")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--crop", type=int, nargs=3, default=[128, 128, 10])
    p.add_argument("--timesteps", type=int, default=None,
                   help="override the recurrence depth")
    p.add_argument("--data-parallel", type=int, default=1,
                   help="shard each train batch over this many devices "
                        "(distinct cards with --device cuda)")
    _add_device(p)


def _add_train_rcnn(sub):
    p = sub.add_parser("train-rcnn", help="train the detection head")
    p.add_argument("data", help="directory of X.tif + X.xml (VOC boxes)")
    p.add_argument("--out", default="detector.hcunet")
    p.add_argument("--epochs", type=int, default=5000)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--gamma", type=float, default=0.997)
    p.add_argument("--scale", type=float, default=3.0)
    p.add_argument("--simple-class", action="store_true")
    p.add_argument("--batch-size", type=int, default=1,
                   help="samples per optimizer step (B=1 losses, gradients "
                        "averaged; the reference is strictly batch=1)")
    p.add_argument("--data-parallel", type=int, default=0,
                   help="shard each global batch over N devices "
                        "(distinct cards with --device cuda)")
    p.add_argument("--backbone", choices=("resnet50", "small"),
                   default="resnet50",
                   help="resnet50 = the reference's production architecture "
                        "(hcat/rcnn.py:14-20); small = a light FPN trunk "
                        "for quick runs")
    _add_device(p)


def _add_pretrain(sub):
    p = sub.add_parser(
        "pretrain-backbone",
        help="pretrain the detector's ResNet trunk on a synthetic shape "
        "task (a substitute for ImageNet weights without a download)",
    )
    p.add_argument("--out", default="backbone.msgpack")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--width", type=int, default=64)
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
    _add_train_rcnn(sub)
    _add_train_recurrent(sub)
    _add_predict_recurrent(sub)
    _add_preprocess(sub)
    _add_validate(sub)
    _add_study(sub)
    _add_pretrain(sub)
    return parser


def pin_float32() -> None:
    """Compute float32 in float32, as the JAX commands do: torch lets
    cuDNN's convs run in TF32 by default, which on the card moved a float32
    ``analyze``'s cell count and a float32 training step's loss (fault F4,
    ``PERF.md``)."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _mesh_devices(n: int, device: str, flag: str) -> list:
    """The ``n`` devices of a command's mesh: ``n`` distinct cards for a
    CUDA ``device`` (the command exits with the JAX command line's message
    when fewer are present: a card is never repeated), else ``n`` entries
    of ``device``."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return [dev] * n
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        if flag == "spatial-shards":
            raise SystemExit(f"--spatial-shards {n} needs {n} devices, have {have}")
        raise SystemExit(f"--{flag} {n} needs that many devices, have {have}")
    return [torch.device("cuda", i) for i in range(n)]


def _make_spatial_mesh(n_shards: int, device: str):
    """``--spatial-shards``'s mesh, or None for one device."""
    if n_shards <= 1:
        return None
    from hcunet_tpu_torch.parallel.mesh import SPATIAL_AXIS, make_mesh

    return make_mesh({SPATIAL_AXIS: n_shards},
                     _mesh_devices(n_shards, device, "spatial-shards"))


def _make_data_mesh(n: int, device: str):
    """``--data-parallel``'s mesh, or None for one device."""
    if not n or n <= 1:
        return None
    from hcunet_tpu_torch.parallel.mesh import DATA_AXIS, make_mesh

    return make_mesh({DATA_AXIS: n}, _mesh_devices(n, device, "data-parallel"))


def main(argv=None):
    args = build_parser().parse_args(argv)
    pin_float32()
    commands = {
        "analyze": _cmd_analyze_like,
        "batch": _cmd_analyze_like,
        "train-unet": _cmd_train_unet,
        "train-rcnn": _cmd_train_rcnn,
        "train-recurrent": _cmd_train_recurrent,
        "predict-recurrent": _cmd_predict_recurrent,
        "preprocess": _cmd_preprocess,
        "validate": _cmd_validate,
        "study": _cmd_study,
        "pretrain-backbone": _cmd_pretrain,
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

    mesh = _make_spatial_mesh(args.spatial_shards, args.device)
    device = args.device if mesh is None else mesh.devices.flat[0]
    model, unet_apply, detector = _load_models(args.unet, args.detector, device)
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
                overlap=tail_workers, mesh=mesh, device=device,
            )
        print(json.dumps({"cells": len(result.cells), "out": out}))
        return 0

    from hcunet_tpu_torch.apps.batch import run_batch

    def one(img, out_dir):
        analyze(
            img, unet_apply=unet_apply, detector=detector, cfg=cfg,
            work_dir=out_dir, overlap=tail_workers, mesh=mesh, device=device,
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

    mesh = _make_data_mesh(args.data_parallel, args.device)
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
        mesh=mesh, device=None if mesh else args.device,
    )
    trainer.fit(ds)
    trainer.save(args.out)
    print(json.dumps({"checkpoint": args.out}))
    return 0


def _cmd_train_recurrent(args):
    import dataclasses

    import torch

    from hcunet_tpu_torch.config import RDCNetConfig, RUNetConfig
    from hcunet_tpu_torch.data import transforms as t
    from hcunet_tpu_torch.data.datasets import RecursiveStack
    from hcunet_tpu_torch.models.unet import init_like_flax
    from hcunet_tpu_torch.train.trainer import RecurrentTrainer, TrainConfig

    mesh = _make_data_mesh(args.data_parallel, args.device)
    # recurrent recipe (reference tests/r_unet_test.py:20-44): joint crops
    # only; the vector field is geometry-coupled, so photometric augments
    # stay on the image
    ds = RecursiveStack(
        args.data,
        joint_transforms=[
            t.to_float(), t.reshape(), t.nul_crop(rate=1),
            t.random_crop(args.crop),
        ],
        image_transforms=[
            t.random_gamma((0.7, 1.3)),
            t.clean_image(),
            t.normalize(),
        ],
    )
    if args.model == "runet":
        from hcunet_tpu_torch.models.runet import RecursiveUNet

        cfg = RUNetConfig()
        if args.timesteps:
            cfg = dataclasses.replace(cfg, timesteps=args.timesteps)
        model = RecursiveUNet(cfg)
    else:
        from hcunet_tpu_torch.models.rdcnet import RDCNet

        cfg = RDCNetConfig()
        if args.timesteps:
            cfg = dataclasses.replace(cfg, timesteps=args.timesteps)
        model = RDCNet(cfg)
    # the JAX models' he_normal kernels and zero biases
    init_like_flax(model, torch.Generator().manual_seed(0), scale=2.0)
    trainer = RecurrentTrainer(
        model, None,
        TrainConfig(learning_rate=args.lr, epochs=args.epochs,
                    checkpoint_path=args.out),
        mesh=mesh, device=None if mesh else args.device,
    )
    trainer.fit(ds)
    trainer.save(args.out)
    print(json.dumps({"checkpoint": args.out, "model": args.model}))
    return 0


def _cmd_train_rcnn(args):
    import torch

    from hcunet_tpu_torch.config import DetectorConfig
    from hcunet_tpu_torch.data import transforms as t
    from hcunet_tpu_torch.data.datasets import Section
    from hcunet_tpu_torch.models import detection
    from hcunet_tpu_torch.models.unet import init_like_flax
    from hcunet_tpu_torch.train.detection_trainer import (
        DetectionTrainConfig,
        DetectionTrainer,
    )
    from hcunet_tpu_torch.utils.checkpoint import save_checkpoint

    mesh = _make_data_mesh(args.data_parallel, args.device)
    batch = args.batch_size if args.batch_size > 1 else (
        args.data_parallel if mesh is not None else 1
    )
    if mesh is not None and batch % args.data_parallel:
        raise SystemExit(
            f"--batch-size {batch} must be a multiple of --data-parallel "
            f"{args.data_parallel}: each device takes batch/N samples of "
            f"the sharded global batch"
        )
    ds = Section(
        args.data,
        image_transforms=[t.to_float(), t.remove_channel()],
        simple_class=args.simple_class,
    )
    n_classes = 3 if args.simple_class else 5
    cfg = DetectorConfig(num_classes=n_classes)
    det = detection.Detector(cfg, backbone=args.backbone, device="cpu")
    # the JAX Detector.init's LeCun-normal kernels (flax's default), zero
    # biases, identity batch norms but each bottleneck's zero last scale
    init_like_flax(det, torch.Generator().manual_seed(0), scale=1.0)
    trainer = DetectionTrainer(
        det, None,
        DetectionTrainConfig(
            learning_rate=args.lr, gamma=args.gamma,
            classifier_scale=args.scale, epochs=args.epochs,
        ),
        steps_per_epoch=max(1, -(-len(ds) // batch)),
        batch_size=batch,
        mesh=mesh, device=None if mesh else args.device,
    )
    trainer.fit(ds)
    save_checkpoint(args.out, trainer.variables, cfg)
    print(json.dumps({"checkpoint": args.out}))
    return 0


def _cmd_pretrain(args):
    from hcunet_tpu_torch.train.pretrain import pretrain_backbone, save_backbone

    backbone = pretrain_backbone(
        steps=args.steps, batch=args.batch, lr=args.lr, width=args.width,
        device=args.device,
    )
    save_backbone(args.out, backbone)
    print(json.dumps({"backbone": args.out}))
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
