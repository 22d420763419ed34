"""The port's ``analyze`` command against the JAX package's, on the CPU
(``--device cpu``), from the same checkpoint files
(``test_torch_port_cli.py::write_checkpoints``) and a uint16 ``.tif`` blob
scene (96 x 96 x 6, 12 cells): the printed cells equal and the
``cells.csv`` files byte-identical, as ``tests/test_torch_port_pipeline.py``
holds ``analyze``."""

import os

import numpy as np
import pytest

from hcunet_tpu import cli as jcli
from hcunet_tpu.benchmarks import _blob_scene
from hcunet_tpu.data.tiff import imwrite
from hcunet_tpu_torch import cli as tcli

from test_torch_port_cli import one_thread, run, small_detector, write_checkpoints  # noqa: F401

SHAPE = (96, 96, 6)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    return write_checkpoints(tmp_path_factory.mktemp("ckpts"))


def _write_scene(path, seed):
    vol, _ = _blob_scene(*SHAPE, n_cells=12, seed=seed)
    imwrite(str(path), np.ascontiguousarray(vol.transpose(2, 1, 0, 3)))  # [Z, Y, X, C] on disk


def test_analyze_matches_jax(tmp_path, capsys, ckpts, small_detector):
    img = tmp_path / "scene.tif"
    _write_scene(img, seed=0)
    common = ["--unet", ckpts["unet"], "--detector", ckpts["detector"], "--no-cochlea"]
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    want = run(capsys, jcli.main, ["analyze", str(img), "--out", jout, *common])
    got = run(capsys, tcli.main, ["analyze", str(img), "--out", tout, *common,
                                   "--device", "cpu", "--trace", str(tmp_path / "trace")])
    assert got == {"cells": want["cells"], "out": tout}
    assert want["cells"] > 0
    with open(os.path.join(jout, "cells.csv"), "rb") as f:
        want_csv = f.read()
    with open(os.path.join(tout, "cells.csv"), "rb") as f:
        assert f.read() == want_csv
    assert os.listdir(tmp_path / "trace")
