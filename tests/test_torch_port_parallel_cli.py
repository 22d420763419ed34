"""The command line's multi-device flags on the CPU (``--device cpu``: N
CPU entries in the mesh): ``analyze --spatial-shards 2`` against the same
command on one device (``cells.csv`` byte for byte, every chunk sharded),
and ``--data-parallel 2`` of ``train-unet``, ``train-recurrent`` and
``train-rcnn`` against a single-device trainer on the same global batches
(the losses within 1e-4 relative, as the JAX mesh trainers are held).
With ``--device cuda`` and too few cards the commands exit
(``test_torch_port_cli.py::test_multi_device_flags_exit_not_ported``).

The commands' tiles are cut to ``TILES`` (the command line takes the
default ``TileConfig``, whose 128-voxel halo does not fit these scenes'
chunks) by wrapping ``analyze``; the trainers' batches are recorded where
the command hands them to ``train_step``."""

import copy
import dataclasses
import os

import numpy as np
import pytest
import torch

from hcunet_tpu.benchmarks import _blob_scene
from hcunet_tpu.data.tiff import imwrite
from hcunet_tpu_torch import cli as tcli
from hcunet_tpu_torch.config import TileConfig
from hcunet_tpu_torch.infer import pipeline as tpipeline
from hcunet_tpu_torch.train import detection_trainer, trainer as ttrainer

from test_torch_port_cli import run, small_detector, write_checkpoints  # noqa: F401
from test_torch_port_cli_train import write_recursive_stack, write_sections
from test_torch_port_validate import write_npy_stack

TILES = TileConfig(eval_size=(16, 24, 6), pad=(16, 16, 2), batch=2)


@pytest.fixture
def small_tiles(monkeypatch):
    """The command line's ``analyze`` on ``TILES``; each call's result kept."""
    results = []
    inner = tpipeline.analyze

    def analyze(*args, cfg, **kwargs):
        results.append(inner(*args, cfg=dataclasses.replace(cfg, tiles=TILES), **kwargs))
        return results[-1]

    monkeypatch.setattr(tpipeline, "analyze", analyze)
    return results


def test_analyze_spatial_shards_on_cpu(tmp_path, capsys, small_detector, small_tiles):  # noqa: F811
    ckpts = write_checkpoints(tmp_path)
    vol, _ = _blob_scene(96, 96, 6, n_cells=12, seed=0)
    img = str(tmp_path / "scene.tif")
    imwrite(img, np.ascontiguousarray(vol.transpose(2, 1, 0, 3)))
    common = ["--unet", ckpts["unet"], "--detector", ckpts["detector"], "--no-cochlea",
              "--numchunks", "2", "--device", "cpu"]
    outs = {n: str(tmp_path / f"shards{n}") for n in (1, 2)}
    got = {n: run(capsys, tcli.main, ["analyze", img, "--out", outs[n], *common,
                                       "--spatial-shards", str(n)]) for n in (1, 2)}
    assert got[2]["cells"] == got[1]["cells"] > 0
    assert [r.mesh_chunks for r in small_tiles] == [None, {"sharded": 1, "fallback": 0}]
    csv = {}
    for n in (1, 2):
        with open(os.path.join(outs[n], "cells.csv"), "rb") as f:
            csv[n] = f.read()
    assert csv[2] == csv[1]


def _record_steps(monkeypatch, cls, method):
    """Wrap ``cls.method`` to keep a copy of the trainer's model before its
    first step and every step's arguments and loss."""
    rec = {"steps": []}
    inner = getattr(cls, method)

    def step(self, *args):
        if "model" not in rec:
            rec["model"] = copy.deepcopy(self.det if hasattr(self, "det") else self.model)
        loss = inner(self, *args)
        rec["steps"].append((copy.deepcopy(args), loss))
        return loss

    monkeypatch.setattr(cls, method, step)
    return rec


@pytest.mark.parametrize("command", ["train-unet", "train-recurrent", "train-rcnn"])
def test_data_parallel_on_cpu_matches_one_device(tmp_path, capsys, monkeypatch, command):
    out = str(tmp_path / "model.hcunet")
    if command == "train-rcnn":
        data = write_sections(tmp_path / "data", n=2)
        rec = _record_steps(monkeypatch, detection_trainer.DetectionTrainer, "train_step_batch")
        argv = ["--backbone", "small", "--lr", "1e-4"]
    elif command == "train-unet":
        data = str(tmp_path / "data")
        write_npy_stack(data, n=4, shape=(112, 112, 8), n_cells=48)
        rec = _record_steps(monkeypatch, ttrainer.UNetTrainer, "train_step")
        argv = ["--crop", "76", "76", "6"]
    else:
        data = write_recursive_stack(tmp_path / "data", n=4)
        rec = _record_steps(monkeypatch, ttrainer.RecurrentTrainer, "train_step")
        argv = ["--model", "rdcnet", "--crop", "16", "16", "6"]
    got = run(capsys, tcli.main, [command, data, "--out", out, "--epochs", "1",
                                   "--data-parallel", "2", "--device", "cpu", *argv])
    assert got["checkpoint"] == out and os.path.exists(out)
    assert len(rec["steps"]) == (1 if command == "train-rcnn" else 2)
    assert all(np.asarray(args[0]).shape[0] == 2 for args, _loss in rec["steps"])
    monkeypatch.undo()  # the replay below steps the trainers unrecorded

    if command == "train-rcnn":
        cfg = detection_trainer.DetectionTrainConfig(learning_rate=1e-4, gamma=1.0)
        single = detection_trainer.DetectionTrainer(rec["model"], None, cfg, batch_size=2,
                                                    device="cpu")
        # train-rcnn's own schedule (gamma 1.0 by default) leaves the rate alone
        want = [single.train_step_batch(*args) for args, _loss in rec["steps"]]
    else:
        cls = ttrainer.UNetTrainer if command == "train-unet" else ttrainer.RecurrentTrainer
        single = cls(rec["model"], None, ttrainer.TrainConfig(learning_rate=1e-3), device="cpu")
        want = [single.train_step(*args) for args, _loss in rec["steps"]]
    np.testing.assert_allclose([loss for _args, loss in rec["steps"]], want, rtol=1e-4)


def test_data_parallel_batch_must_divide(tmp_path, capsys):
    data = write_sections(tmp_path / "data", n=2)
    with pytest.raises(SystemExit, match="must be a multiple of --data-parallel 2"):
        tcli.main(["train-rcnn", data, "--out", str(tmp_path / "d.hcunet"), "--backbone",
                   "small", "--batch-size", "3", "--data-parallel", "2", "--device", "cpu"])
