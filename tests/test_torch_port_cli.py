"""The port's command line (``hcunet_tpu_torch/cli.py``) against the JAX
package's (``hcunet_tpu/cli.py``), on the CPU (``--device cpu``), from the
same files; ``test_torch_port_cli_analyze.py`` and
``test_torch_port_cli_validate.py`` hold ``analyze``, ``batch`` and
``validate`` on the shared set-up below.

* The parsers: each ported subcommand has the JAX one's options, defaults
  and choices, plus ``--device``; the subcommands are the JAX set less the
  named pending ones.
* ``preprocess``: the same target files; ``study``: the same
  ``study.csv`` and regression (within 1e-12).
* ``train-unet``: the port's weights start from another generator than
  JAX's, so the checkpoint it writes is held by JAX's ``load_unet``, whose
  forward must equal the port's within atol 5e-5.
* ``--spatial-shards 2`` and ``--data-parallel 2`` need two cards with the
  default device, CUDA, and exit with the JAX message without them
  (``test_torch_port_parallel_cli.py`` runs them on the CPU); without a
  card the commands raise.

The shared set-up: one JAX-format U-Net checkpoint (the two-level
``SMALL`` net, random weights from a seed, its output conv negated and
scaled by 10 so that its map follows the blobs, as in
``tests/test_torch_port_pipeline.py``) and one detector checkpoint (the
small-backbone detector of that test, random weights from a seed; both
command lines rebuild a checkpoint's detector as the ResNet50-FPN at width
64, so ``small_detector`` patches both to build the small one).
"""

import argparse
import functools
import json
import os
import pickle
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hcunet_tpu.models.detection as jdetection
import hcunet_tpu_torch.models.detection as tdetection
from hcunet_tpu import cli as jcli
from hcunet_tpu.config import DetectorConfig as JaxDetectorConfig
from hcunet_tpu.config import UNetConfig as JaxUNetConfig
from hcunet_tpu.data.tiff import imread, imwrite
from hcunet_tpu.infer.pipeline import _save_cells
from hcunet_tpu.utils.checkpoint import load_unet as jax_load_unet
from hcunet_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from hcunet_tpu_torch import cli as tcli
from hcunet_tpu_torch.analysis.haircell import HairCell
from hcunet_tpu_torch.utils.checkpoint import load_unet

from test_torch_port_detection import CFG as DET_CFG
from test_torch_port_detection import _detectors
from test_torch_port_validate import blob_unet, write_npy_stack
from torch_port_support import SMALL


@pytest.fixture
def small_detector(monkeypatch):
    """Both command lines rebuild a checkpoint's detector with the small
    backbone (at width 8, as ``_detectors`` makes it)."""
    for mod in (jdetection, tdetection):
        monkeypatch.setattr(mod, "Detector", functools.partial(
            mod.Detector, backbone="small", backbone_width=8))


def write_checkpoints(root) -> dict:
    """The shared U-Net and detector checkpoints, written by the JAX
    package's ``save_checkpoint`` into ``root``."""
    cfg, _jmodel, variables = blob_unet()
    unet = str(root / "unet.hcunet")
    jax_save_checkpoint(unet, variables, JaxUNetConfig(**SMALL), snapshot_sources=False)
    _jdet, det_vars, _tdet = _detectors("small")
    det = str(root / "detector.hcunet")
    jax_save_checkpoint(det, det_vars, JaxDetectorConfig(**DET_CFG), snapshot_sources=False)
    return {"unet": unet, "detector": det, "cfg": cfg}


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    return write_checkpoints(tmp_path_factory.mktemp("ckpts"))


def json_tail(out: str):
    """The JSON document a command printed last (one line, or an indented
    block starting at a line that opens it)."""
    lines = out.strip().splitlines()
    for i in range(len(lines) - 1, -1, -1):
        if lines[i].startswith(("{", "[")):
            try:
                return json.loads("\n".join(lines[i:]))
            except json.JSONDecodeError:
                continue
    raise AssertionError(f"no JSON in {out!r}")


def run(capsys, main, argv):
    """``main(argv)``, which must return 0, and the JSON it printed."""
    capsys.readouterr()
    assert main(argv) == 0
    return json_tail(capsys.readouterr().out)


# --- parsers -----------------------------------------------------------------


class _Stop(Exception):
    pass


def _jax_parser() -> argparse.ArgumentParser:
    """The parser ``hcunet_tpu.cli.main`` builds, caught at ``parse_args``."""
    seen = {}

    def grab(self, *a, **k):
        seen["parser"] = self
        raise _Stop

    with mock.patch.object(argparse.ArgumentParser, "parse_args", grab):
        with pytest.raises(_Stop):
            jcli.main([])
    return seen["parser"]


def _subparsers(parser):
    (action,) = [a for a in parser._actions if isinstance(a, argparse._SubParsersAction)]
    return action.choices


def _options(sub):
    return {
        a.dest: (tuple(a.option_strings), type(a).__name__, a.default, a.type,
                 None if a.choices is None else tuple(a.choices), a.nargs, a.required, a.const)
        for a in sub._actions if a.dest != "help"
    }


# the JAX command line's subcommands whose back ends the port has not yet
NOT_PORTED = ()


def test_parsers_match_jax():
    jsubs = _subparsers(_jax_parser())
    tsubs = _subparsers(tcli.build_parser())
    assert set(tsubs) == set(jsubs) - set(NOT_PORTED)
    assert set(NOT_PORTED) <= set(jsubs)
    for name, sub in tsubs.items():
        got, want = _options(sub), _options(jsubs[name])
        device = got.pop("device", None)
        assert got == want, name
        if name in ("analyze", "batch", "train-unet", "validate", "predict-recurrent",
                    "train-rcnn", "train-recurrent", "pretrain-backbone"):
            assert device == (("--device",), "_StoreAction", "cuda", None, None, None, False, None)
        else:
            assert device is None, name


@pytest.mark.parametrize("argv", [
    ["analyze", "v.tif", "--unet", "u", "--spatial-shards", "2"],
    ["batch", "root", "--unet", "u", "--spatial-shards", "2"],
    ["train-unet", "data", "--data-parallel", "2"],
    ["train-recurrent", "data", "--data-parallel", "2"],
    ["train-rcnn", "data", "--data-parallel", "2"],
])
def test_multi_device_flags_exit_not_ported(argv):
    """The multi-device flags run over N distinct cards with ``--device
    cuda`` (the default): with fewer cards present (none here), the command
    exits with the JAX command line's message before it reads anything,
    and never repeats a card."""
    with pytest.raises(SystemExit, match=r"--(spatial-shards|data-parallel) 2 needs"):
        tcli.main(argv)


def test_cuda_is_the_default_device(monkeypatch, ckpts, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(["analyze", str(tmp_path / "v.tif"), "--unet", ckpts["unet"]])


# --- preprocess, study ----------------------------------------------------


def _color_volume():
    color = np.zeros((6, 40, 36, 3), np.uint8)  # [Z, Y, X, RGB] on disk
    color[...] = [10, 10, 10]
    color[:, 8:16, 8:16] = [200, 0, 0]
    color[1:5, 22:30, 20:28] = [0, 200, 0]
    color[2:, 30:38, 4:10] = [0, 0, 200]
    return color


def test_preprocess_matches_jax(tmp_path, capsys):
    dirs = {}
    for side in ("jax", "port"):
        dirs[side] = tmp_path / side
        dirs[side].mkdir()
        imwrite(str(dirs[side] / "s0.labels.tif"), _color_volume())
    assert run(capsys, jcli.main, ["preprocess", str(dirs["jax"]), "--workers", "1"]) == {
        "processed": 1}
    assert run(capsys, tcli.main, ["preprocess", str(dirs["port"]), "--workers", "2"]) == {
        "processed": 1}
    assert sorted(os.listdir(dirs["port"])) == sorted(os.listdir(dirs["jax"])) == [
        "s0.labels.com.tif", "s0.labels.tif", "s0.labels.vector.pkl"]
    np.testing.assert_array_equal(imread(str(dirs["port"] / "s0.labels.com.tif")),
                                  imread(str(dirs["jax"] / "s0.labels.com.tif")))
    vecs = []
    for side in ("port", "jax"):
        with open(dirs[side] / "s0.labels.vector.pkl", "rb") as f:
            vecs.append(pickle.load(f))
    np.testing.assert_array_equal(vecs[0], vecs[1])
    assert tcli.main(["preprocess", str(tmp_path / "nothing")]) == 1


def test_study_matches_jax(tmp_path, capsys):
    dirs = []
    for gain in (10, 30):
        d = tmp_path / f"Feb 6 CMV m1 G{gain} L1_cellBycell"
        d.mkdir()
        cells = []
        for i in range(3):
            c = HairCell([0, 0, 0, 1, 1, 1], [0, 0, 0], unique_id=i + 1)
            c.signal_stats = {"gfp": {"mean": 0.1 * gain + 0.01 * i, "std": 0.1,
                                      "median": 0.1 * gain}}
            c.gfp_stats = c.signal_stats["gfp"]
            cells.append(c)
        _save_cells(str(d / "chunk_1_1.cells.npz"), cells)
        dirs.append(str(d))
    want = run(capsys, jcli.main, ["study", *dirs, "--out", str(tmp_path / "jax")])
    got = run(capsys, tcli.main, ["study", *dirs, "--out", str(tmp_path / "port")])
    assert (got["images"], got["cells"]) == (want["images"], want["cells"]) == (2, 6)
    for k, v in want["gfp_vs_gain"].items():
        assert abs(got["gfp_vs_gain"][k] - v) <= 1e-12, k
    with open(tmp_path / "jax" / "study.csv") as f:
        want_csv = f.read()
    with open(tmp_path / "port" / "study.csv") as f:
        assert f.read() == want_csv
    assert [os.path.basename(p) for p in got["figures"]] == [
        os.path.basename(p) for p in want["figures"]]
    assert tcli.main(["study", str(tmp_path / "empty"), "--out", str(tmp_path / "x")]) == 1


# --- train-unet ----------------------------------------------------------------


def test_train_unet_checkpoint_loads_in_jax(tmp_path, capsys):
    root = str(tmp_path / "stack")
    write_npy_stack(root, shape=(96, 96, 8), n_cells=24)
    out = str(tmp_path / "unet.hcunet")
    got = run(capsys, tcli.main, ["train-unet", root, "--out", out, "--epochs", "1",
                                   "--crop", "76", "76", "6", "--device", "cpu"])
    assert got == {"checkpoint": out}
    jmodel, jvars, hyper = jax_load_unet(out)
    assert hyper["learning_rate"] == 1e-3
    tmodel, _, _ = load_unet(out)
    x = np.random.default_rng(3).random((1, 76, 76, 6, 4), np.float32)
    want = np.asarray(jmodel.apply(jvars, jnp.asarray(x), train=False))
    with torch.no_grad():
        tgot = tmodel(torch.from_numpy(x)).numpy()
    assert tgot.shape == want.shape == (1, 30, 30, 2, 1)
    np.testing.assert_allclose(tgot, want, atol=5e-5, rtol=0)
    # the fit moved the batch-norm statistics from their initial values
    assert not np.allclose(jvars["batch_stats"]["down0"]["ConvBNRelu_0"]["BatchNorm_0"]["var"], 1.0)


# --- checkpoints the command line reads -----------------------------------------


@pytest.mark.parametrize("backbone", ["small", "resnet50"])
def test_detector_checkpoint_written_by_the_port_loads_in_jax(tmp_path, backbone):
    """The port writes a detector checkpoint (``chip_smoke.py`` hands its
    detector to the command line so) that the JAX package reads leaf for
    leaf, and that the port reads back to the same state dict."""
    from hcunet_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
    from hcunet_tpu_torch.utils.checkpoint import load_model, save_checkpoint
    from hcunet_tpu_torch.utils.port_jax import jax_variables_from_detector_state_dict

    _jdet, variables, tdet = _detectors(backbone)
    path = str(tmp_path / "det.hcunet")
    save_checkpoint(path, jax_variables_from_detector_state_dict(tdet.state_dict(), backbone),
                    tdet.config, snapshot_sources=False)
    cfg, got, _ = jax_load_checkpoint(path)
    assert cfg == JaxDetectorConfig(**DET_CFG)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(variables))
    assert len(flat_got) == len(flat_want)
    for key, leaf in flat_got:
        np.testing.assert_array_equal(leaf, flat_want[key], err_msg=str(key))
    with mock.patch.object(tdetection, "Detector", functools.partial(
            tdetection.Detector, backbone=backbone, backbone_width=8)):
        det, _v, _h = load_model(path, device="cpu")
    for k, v in tdet.state_dict().items():
        assert torch.equal(det.state_dict()[k], v), k
