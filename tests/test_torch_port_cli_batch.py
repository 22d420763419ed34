"""The port's ``batch`` command against the JAX package's, on the CPU
(``--device cpu``), from the same checkpoint files
(``test_torch_port_cli.py::write_checkpoints``) over two uint16 ``.tif``
blob scenes (``test_torch_port_cli_analyze.py``): the same states and
byte-identical ``cells.csv`` files; a second ``batch`` reports both images
cached."""

import os

import pytest

from hcunet_tpu import cli as jcli
from hcunet_tpu_torch import cli as tcli

from test_torch_port_cli import run, small_detector, write_checkpoints  # noqa: F401
from test_torch_port_cli_analyze import _write_scene


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    return write_checkpoints(tmp_path_factory.mktemp("ckpts"))


def test_batch_matches_jax_and_resumes(tmp_path, capsys, ckpts, small_detector):
    roots = {}
    for side in ("jax", "port"):
        roots[side] = tmp_path / side
        roots[side].mkdir()
        for i in range(2):
            _write_scene(roots[side] / f"scene{i}.tif", seed=i + 1)
    common = ["--unet", ckpts["unet"], "--detector", ckpts["detector"], "--numchunks", "2"]
    want = run(capsys, jcli.main, ["batch", str(roots["jax"]), *common])
    got = run(capsys, tcli.main, ["batch", str(roots["port"]), *common, "--device", "cpu"])
    assert [(os.path.basename(r["image"]), r["state"]) for r in got] == [
        (os.path.basename(r["image"]), r["state"]) for r in want
    ] == [("scene0.tif", "done"), ("scene1.tif", "done")]
    for i in range(2):
        with open(roots["jax"] / f"scene{i}_cellBycell" / "cells.csv", "rb") as f:
            want_csv = f.read()
        with open(roots["port"] / f"scene{i}_cellBycell" / "cells.csv", "rb") as f:
            assert f.read() == want_csv
    again = run(capsys, tcli.main, ["batch", str(roots["port"]), *common, "--device", "cpu"])
    assert [r.get("cached") for r in again] == [True, True]
