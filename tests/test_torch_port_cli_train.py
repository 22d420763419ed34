"""The port's training commands (``train-recurrent``, ``train-rcnn
--backbone small``, ``pretrain-backbone``) through ``cli.main(...,
"--device", "cpu")`` on tiny data made from a seed: their parsers equal to
the JAX command line's (options, defaults, choices; plus ``--device``),
the files they write read by the JAX package, and TF32 turned off by
``main``.  The port's weights start
from its own seeded generator (the JAX initializers' distributions), so the
written checkpoints are held by the JAX models' outputs on them: equal to
the port's within atol 5e-5 (recurrent) and 1e-3 px / 1e-5 (detections).
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcunet_tpu.config import DetectorConfig as JaxDetectorConfig
from hcunet_tpu.config import RDCNetConfig as JaxRDCNetConfig
from hcunet_tpu.config import RUNetConfig as JaxRUNetConfig
from hcunet_tpu.data.tiff import imwrite
from hcunet_tpu.models.detection import Detector as JaxDetector
from hcunet_tpu.models.rdcnet import RDCNet as JaxRDCNet
from hcunet_tpu.models.resnet import ResNet as JaxResNet
from hcunet_tpu.models.runet import RecursiveUNet as JaxRecursiveUNet
from hcunet_tpu.train.pretrain import load_backbone as jax_load_backbone
from hcunet_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from hcunet_tpu_torch import cli as tcli
from hcunet_tpu_torch.utils.checkpoint import load_model

from test_torch_port_cli import _jax_parser, _options, _subparsers, run

COMMANDS = ("train-recurrent", "train-rcnn", "pretrain-backbone")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the CPU's float32 sums depend on the thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", COMMANDS)
def test_training_parsers_match_jax(name):
    got = _options(_subparsers(tcli.build_parser())[name])
    want = _options(_subparsers(_jax_parser())[name])
    device = got.pop("device")
    assert got == want
    assert device == (("--device",), "_StoreAction", "cuda", None, None, None, False, None)


def write_recursive_stack(root, n=2, spatial=(24, 24, 6), seed=0):
    """``n`` RecursiveStack samples: image, mask and pwl (``.npy``, the
    TIFF layout ``[Z, Y, X, C]``), the center map (TIFF) and the vector
    field (pickle)."""
    rng = np.random.default_rng(seed)
    root.mkdir()
    X, Y, Z = spatial
    for i in range(n):
        stem = root / f"s{i}"
        m = np.zeros((Z, Y, X), np.float32)
        m[1:5, 4:14, 6:18] = 1.0
        np.save(f"{stem}.npy", rng.random((Z, Y, X, 4)).astype(np.float32))
        np.save(f"{stem}.mask.npy", m)
        np.save(f"{stem}.pwl.npy", (rng.random((Z, Y, X)) + 0.5).astype(np.float32))
        imwrite(f"{stem}.labels.com.tif", (m * 3).astype(np.uint16))
        with open(f"{stem}.labels.vector.pkl", "wb") as f:
            pickle.dump((rng.random((Z, Y, X, 3)) - 0.5).astype(np.float32), f)
    return str(root)


@pytest.mark.parametrize("model", ["rdcnet", "runet"])
def test_train_recurrent_checkpoint_loads_in_jax(tmp_path, capsys, model):
    data = write_recursive_stack(tmp_path / "data")
    out = str(tmp_path / f"{model}.hcunet")
    got = run(capsys, tcli.main, ["train-recurrent", data, "--model", model, "--out", out,
                                   "--epochs", "1", "--crop", "16", "16", "4",
                                   "--timesteps", "2", "--device", "cpu"])
    assert got == {"checkpoint": out, "model": model}
    cfg, variables, hyper = jax_load_checkpoint(out)
    assert hyper["learning_rate"] == 1e-3
    if model == "runet":
        assert cfg == JaxRUNetConfig(timesteps=2)
        jmodel = JaxRecursiveUNet(cfg)
        # the fit moved the running statistics from their initial values
        assert not np.allclose(
            variables["batch_stats"]["step"]["down1"]["SameConvBNRelu_0"]["BatchNorm_0"]["var"], 1.0)
    else:
        assert cfg == JaxRDCNetConfig(timesteps=2)
        jmodel = JaxRDCNet(cfg)
    x = np.random.default_rng(3).standard_normal((1, 16, 16, 4, 4)).astype(np.float32)
    want = np.asarray(jmodel.apply(jax.tree.map(jnp.asarray, variables), jnp.asarray(x)))
    tmodel, _v, _h = load_model(out, device="cpu")
    with torch.no_grad():
        tgot = tmodel(torch.from_numpy(x)).float().numpy()
    np.testing.assert_allclose(tgot, want, atol=5e-5, rtol=0)


def write_sections(root, n=2, hw=(64, 64), seed=0):
    """``n`` Section samples: a 3-channel uint8 TIFF and its VOC boxes."""
    rng = np.random.default_rng(seed)
    root.mkdir()
    names = ("OHC1", "OHC2", "OHC3", "IHC")
    for i in range(n):
        img = (rng.random((*hw, 3)) * 60).astype(np.uint8)
        objects = []
        for k in range(3):
            x0, y0 = (int(v) for v in rng.integers(2, 40, 2))
            w, h = (int(v) for v in rng.integers(10, 20, 2))
            img[y0:y0 + h, x0:x0 + w] += 120
            objects.append(
                f"<object><name>{names[(i + k) % 4]}</name><bndbox><xmin>{x0}</xmin>"
                f"<ymin>{y0}</ymin><xmax>{x0 + w}</xmax><ymax>{y0 + h}</ymax></bndbox></object>")
        imwrite(str(root / f"sec{i}.tif"), img)
        (root / f"sec{i}.xml").write_text(f"<annotation>{''.join(objects)}</annotation>")
    return str(root)


def test_train_rcnn_checkpoint_loads_in_jax(tmp_path, capsys):
    data = write_sections(tmp_path / "data")
    out = str(tmp_path / "det.hcunet")
    got = run(capsys, tcli.main, ["train-rcnn", data, "--out", out, "--epochs", "1",
                                   "--backbone", "small", "--batch-size", "2",
                                   "--lr", "1e-4", "--device", "cpu"])
    assert got == {"checkpoint": out}
    cfg, variables, _ = jax_load_checkpoint(out)
    assert cfg == JaxDetectorConfig(num_classes=5)
    # trained from the zero-init detector's start: the trunk's statistics moved
    assert not np.allclose(variables["trunk"]["batch_stats"]["body"]["BatchNorm_0"]["var"], 1.0)
    img = np.random.default_rng(4).random((1, 64, 64, 3), np.float32)
    want = jax.tree.map(np.asarray, JaxDetector(cfg, backbone="small").detect(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(img)))
    from hcunet_tpu_torch.config import DetectorConfig
    from hcunet_tpu_torch.models.detection import Detector
    from hcunet_tpu_torch.utils.port_jax import detector_state_dict_from_jax_variables

    det = Detector(DetectorConfig(num_classes=5), backbone="small", device="cpu")
    det.load_state_dict(detector_state_dict_from_jax_variables(variables, "small"))
    got = {k: v.numpy() for k, v in det.detect(img).items()}
    np.testing.assert_array_equal(got["valid"], want["valid"])
    v = want["valid"]
    np.testing.assert_array_equal(got["labels"][v], want["labels"][v])
    np.testing.assert_allclose(got["boxes"][v], want["boxes"][v], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got["scores"][v], want["scores"][v], atol=1e-5, rtol=0)


def test_pretrain_backbone_file_loads_in_jax(tmp_path, capsys, monkeypatch):
    """The backbone file reads in the JAX package against the trunk's
    template; and the command line computes float32 in float32: ``main``
    turns TF32 off whatever the process had (fault F4)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    out = str(tmp_path / "backbone.msgpack")
    got = run(capsys, tcli.main, ["pretrain-backbone", "--out", out, "--steps", "2",
                                   "--batch", "2", "--width", "8", "--device", "cpu"])
    assert got == {"backbone": out}
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    template = jax.eval_shape(
        lambda x: JaxResNet(width=8).init(jax.random.PRNGKey(0), x),
        jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), template)
    back = jax_load_backbone(out, template=template)
    leaves = jax.tree.leaves(back)
    assert len(leaves) == len(jax.tree.leaves(template))
    assert all(np.isfinite(np.asarray(a)).all() for a in leaves)
