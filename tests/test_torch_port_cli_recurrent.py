"""The port's ``predict-recurrent`` command against the JAX command, on the
CPU (``--device cpu``), from one JAX-written checkpoint and the same
``.npy`` stacks: the same JSON (inputs to ``<stem>.recurrent.npy``) and
outputs within 4 % of their scale in bfloat16 (the serving forward's
dtype; the JAX packed convs sum in bfloat16, K1 in float32, and 10 steps
of the recurrence carry each rounding on), and at atol 5e-5 with
``--no-packed`` (both the model's float32 forward; RDCNet at 1e-5 of its
output's scale).  Same-shaped stacks go in one batch, a third of another
shape alone; ``--split-x 2`` runs each volume alone on 64-wide x-tiles."""

import json
import os

import numpy as np
import pytest
import torch

from hcunet_tpu import cli as jcli
from hcunet_tpu.config import UNetConfig as JaxUNetConfig
from hcunet_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from hcunet_tpu_torch import cli as tcli
from hcunet_tpu_torch.infer.compile_recurrent import compile_recurrent_apply
from hcunet_tpu_torch.utils.checkpoint import load_model
from tests.test_torch_port_recurrent import jax_recurrent, share_of_scale
from tests.torch_port_support import SMALL, jax_unet

# per family: the stacks' [X, Y, Z] (two of the first shape, one of the second)
SHAPES = {"runet": ((16, 16, 5), (24, 16, 5)), "rdcnet": ((16, 16, 10), (24, 16, 10))}


def _stacks(root, shapes):
    """uint16 stacks in the on-disk layout [Z, Y, X, C]; returns their paths."""
    rng = np.random.default_rng(0)
    paths = []
    for i, shape in enumerate((shapes[0], shapes[0], shapes[1])):
        vol = rng.integers(0, 65535, (*shape, 4), dtype=np.uint16)
        path = os.path.join(root, f"s{i}.npy")
        np.save(path, np.ascontiguousarray(vol.transpose(2, 1, 0, 3)))
        paths.append(path)
    return paths


def _run(capsys, main, argv):
    capsys.readouterr()
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("family", ["runet", "rdcnet"])
def test_predict_recurrent_matches_jax(tmp_path, capsys, family):
    _model, jmodel, variables = jax_recurrent(family, SHAPES[family][0], timesteps=10)
    ckpt = str(tmp_path / "model.hcunet")
    jax_save_checkpoint(ckpt, variables, jmodel.config, snapshot_sources=False)
    paths = _stacks(str(tmp_path), SHAPES[family])
    for flags, close in (([], "share"), (["--no-packed"], "atol")):
        outs = {}
        for side, main, extra in (("jax", jcli.main, []), ("port", tcli.main, ["--device", "cpu"])):
            out_dir = str(tmp_path / f"{side}{len(flags)}")
            info = _run(capsys, main, ["predict-recurrent", *paths, "--checkpoint", ckpt,
                                       "--out-dir", out_dir, *flags, *extra])
            assert sorted(info["outputs"]) == sorted(paths)
            for p in paths:
                stem = os.path.splitext(os.path.basename(p))[0]
                assert info["outputs"][p] == os.path.join(out_dir, stem + ".recurrent.npy")
            outs[side] = {p: np.load(info["outputs"][p]) for p in paths}
        for p in paths:
            got, want = outs["port"][p], outs["jax"][p]
            assert got.dtype == np.float32 and got.shape == want.shape
            if close == "share":
                assert share_of_scale(got, want) < 0.04, p
            else:
                atol = 5e-5 if family == "runet" else 1e-5 * np.abs(want).max()
                np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_predict_recurrent_split_x_and_errors(tmp_path, capsys):
    """``--split-x 2`` on a 128-wide stack (the split engages: core 64 >=
    halo 32) equals ``compile_recurrent_apply(split_x=2)`` on the same
    volume exactly, and the JAX command's within 4 % of the scale; a
    U-Net checkpoint is refused."""
    model, jmodel, variables = jax_recurrent("runet", (16, 16, 5), timesteps=3)
    ckpt = str(tmp_path / "runet.hcunet")
    jax_save_checkpoint(ckpt, variables, jmodel.config, snapshot_sources=False)
    vol = np.random.default_rng(3).random((128, 16, 5, 4)).astype(np.float32)
    path = str(tmp_path / "wide.npy")
    np.save(path, np.ascontiguousarray(vol.transpose(2, 1, 0, 3)))
    info = _run(capsys, tcli.main, ["predict-recurrent", path, "--checkpoint", ckpt,
                                    "--out-dir", str(tmp_path / "port"), "--split-x", "2",
                                    "--device", "cpu"])
    got = np.load(info["outputs"][path])
    loaded, _v, _h = load_model(ckpt, device="cpu")
    want = compile_recurrent_apply(loaded, device="cpu", split_x=2)(
        torch.from_numpy((vol - 0.5) / 0.5)[None])[0].numpy()
    np.testing.assert_array_equal(got, want)
    jinfo = _run(capsys, jcli.main, ["predict-recurrent", path, "--checkpoint", ckpt,
                                     "--out-dir", str(tmp_path / "jax"), "--split-x", "2"])
    assert share_of_scale(got, np.load(jinfo["outputs"][path])) < 0.04

    _cfg, _jm, uvars = jax_unet(SMALL, (40, 40, 8))
    unet = str(tmp_path / "unet.hcunet")
    jax_save_checkpoint(unet, uvars, JaxUNetConfig(**SMALL), snapshot_sources=False)
    with pytest.raises(SystemExit, match="not a recurrent checkpoint"):
        tcli.main(["predict-recurrent", path, "--checkpoint", unet, "--device", "cpu"])
