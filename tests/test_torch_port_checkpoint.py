"""The checkpoint format across the two packages: the port's flax-msgpack
codec (``utils/_flax_msgpack.py``) against flax, checkpoints and training
states written by one package and read by the other, and
``Segmenter.from_checkpoint``.  Arrays cross bit for bit; model outputs
are compared at float32's summation tolerance (1e-5)."""

import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import hcunet_tpu_torch
from hcunet_tpu.config import UNetConfig as JaxUNetConfig
from hcunet_tpu.infer.serving import Segmenter as JaxSegmenter
from hcunet_tpu.train.trainer import TrainConfig as JaxTrainConfig
from hcunet_tpu.train.trainer import UNetTrainer as JaxUNetTrainer
from hcunet_tpu.utils import checkpoint as jckpt
from hcunet_tpu_torch.config import TileConfig, config_to_dict
from hcunet_tpu_torch.infer.serving import Segmenter
from hcunet_tpu_torch.train.trainer import TrainConfig, UNetTrainer
from hcunet_tpu_torch.utils import _flax_msgpack as codec
from hcunet_tpu_torch.utils import checkpoint as tckpt
from hcunet_tpu_torch.utils.port_jax import jax_variables_from_unet_state_dict
from tests.torch_port_support import (
    SMALL,
    SMALL_G2,
    TRAIN_SPATIAL,
    assert_trajectories_match,
    flat,
    jax_unet,
    port_unet,
    train_batch,
)


def _same_tree(a, b):
    """Same structure, and leaves equal bit for bit with the same dtype."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b)
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    elif isinstance(a, (np.ndarray, np.generic)):
        assert isinstance(b, (np.ndarray, np.generic))
        assert a.dtype == b.dtype and np.shape(a) == np.shape(b)
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    else:
        assert type(a) is type(b) and a == b


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {
            "kernel": rng.standard_normal((3, 3, 2, 4, 8)).astype(np.float32),
            "f64": rng.standard_normal(5),
            "half": rng.standard_normal(7).astype(np.float16),
            "empty": np.zeros((0, 3), np.float32),
        },
        "counts": {"i32": np.asarray(7, np.int32), "u8": np.arange(300, dtype=np.uint8),
                   "i64": np.arange(-5, 5, dtype=np.int64), "flags": np.array([True, False])},
        "scalars": {"np": np.float32(2.5), "int": 70000, "neg": -40000, "small": -3,
                    "float": 0.1, "none": None, "true": True},
        "text": "x" * 40, "blob": b"\x01" * 300, "list": list(range(20)),
        "wide": {str(k): k for k in range(20)}, "nothing": {}, "pair": (1.5, "b"),
    }


def test_codec_writes_the_bytes_flax_writes():
    tree = _tree()
    assert codec.to_bytes(tree) == serialization.to_bytes(tree)
    _same_tree(codec.msgpack_restore(codec.to_bytes(tree)), serialization.msgpack_restore(codec.to_bytes(tree)))


def test_codec_reads_flax_bytes():
    """Bytes from ``flax.serialization.to_bytes`` of JAX arrays (a JAX
    UNet's variables and an optax state), read bit for bit as flax reads
    them; bf16 arrays widened to float32 exactly."""
    _cfg, _m, variables = jax_unet(SMALL, TRAIN_SPATIAL)
    jvars = jax.tree.map(jnp.asarray, variables)
    import optax

    opt_state = optax.adam(1e-3).init(jvars["params"])
    for target in (jvars, opt_state, {"a": jnp.arange(6, dtype=jnp.int32).reshape(2, 3)}):
        raw = serialization.to_bytes(target)
        _same_tree(codec.msgpack_restore(raw), serialization.msgpack_restore(raw))
    x = jnp.asarray(np.random.default_rng(0).standard_normal(9), jnp.bfloat16)
    got = codec.msgpack_restore(serialization.to_bytes({"x": x}))["x"]
    assert got.dtype == np.float32 and np.array_equal(got, np.asarray(x.astype(jnp.float32)))


def test_codec_chunked_arrays(monkeypatch):
    """flax splits an array above ``MAX_CHUNK_SIZE`` bytes into chunks: with
    the limit cut to 64 bytes on both sides, the codec writes flax's bytes
    and reads them back whole."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(codec, "MAX_CHUNK_SIZE", 64)
    tree = {"x": np.random.default_rng(1).standard_normal((10, 7)).astype(np.float32),
            "y": {"w": np.arange(50, dtype=np.int32)}}
    raw = serialization.msgpack_serialize(tree)
    assert codec.to_bytes(tree) == raw
    _same_tree(codec.msgpack_restore(raw), tree)


def test_codec_refuses_what_it_does_not_carry():
    with pytest.raises(TypeError):
        codec.to_bytes({"s": {1, 2}})
    with pytest.raises(ValueError, match="complex"):
        codec.msgpack_restore(serialization.msgpack_serialize({"c": 1 + 2j}))
    with pytest.raises(ValueError):
        codec.msgpack_restore(codec.to_bytes({"a": 1})[:-1])


def _x(seed=1):
    return np.random.default_rng(seed).random((1, 40, 40, 8, 4), np.float32)


def test_port_checkpoint_loads_in_jax_and_back(tmp_path):
    """A checkpoint the port writes, loaded by the JAX ``load_unet``, and
    one the JAX package writes, loaded by the port's: the same outputs, the
    same variables bit for bit, the same config."""
    cfg, jmodel, variables = jax_unet(SMALL_G2, (40, 40, 8))
    model = port_unet(cfg, variables)
    port_path, jax_path = str(tmp_path / "port.hcunet"), str(tmp_path / "jax.hcunet")
    tckpt.save_checkpoint(port_path, jax_variables_from_unet_state_dict(model.state_dict(), cfg),
                          cfg, {"epochs": 3})
    jckpt.save_checkpoint(jax_path, variables, JaxUNetConfig(**SMALL_G2), {"epochs": 3})
    x = _x()
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))

    jm, jv, jh = jckpt.load_unet(port_path)
    assert jh == {"epochs": 3} and jm.config == JaxUNetConfig(**SMALL_G2)
    _same_tree(flat(jv), flat(variables))
    np.testing.assert_allclose(np.asarray(jm.apply(jv, jnp.asarray(x), train=False)), want,
                               rtol=0, atol=1e-5)

    tm, tv, th = tckpt.load_unet(jax_path)
    assert th == {"epochs": 3} and tm.config == cfg
    _same_tree(flat(tv), flat(variables))
    with torch.no_grad():
        np.testing.assert_allclose(tm(torch.from_numpy(x)).numpy(), want, rtol=0, atol=1e-5)

    with zipfile.ZipFile(port_path) as z:
        names = z.namelist()
        manifest = json.loads(z.read("manifest.json"))
        assert json.loads(z.read("config.json")) == json.loads(json.dumps(config_to_dict(cfg)))
    assert manifest["version"] == hcunet_tpu_torch.__version__
    assert "sources/train/trainer.py" in names and "sources/utils/checkpoint.py" in names
    assert "csrc/conv3d_valid.cu" in manifest["tree_structure"]
    tckpt.load_checkpoint(port_path, variables_template=variables)
    with pytest.raises(ValueError, match="template"):
        tckpt.load_checkpoint(port_path, variables_template={"params": {}})


def test_load_model_families(tmp_path):
    """``load_model`` rebuilds the UNet; the recurrent families raise,
    naming what is missing."""
    import hcunet_tpu.config as J

    cfg, _jm, variables = jax_unet(SMALL, (40, 40, 8))
    path = str(tmp_path / "unet.hcunet")
    jckpt.save_checkpoint(path, variables, J.UNetConfig(**SMALL))
    model, _v, _h = tckpt.load_model(path)
    assert model.config == cfg
    for rcfg, family in ((J.RUNetConfig(), "RecursiveUNet"), (J.RDCNetConfig(), "RDCNet")):
        rpath = str(tmp_path / f"{family}.hcunet")
        jckpt.save_checkpoint(rpath, {"params": {"w": np.zeros(2, np.float32)}}, rcfg,
                              snapshot_sources=False)
        with pytest.raises(NotImplementedError, match=family):
            tckpt.load_model(rpath)


def test_segmenter_from_checkpoint_matches_jax(tmp_path):
    """``Segmenter.from_checkpoint`` of a JAX-written checkpoint against the
    JAX ``Segmenter.from_checkpoint`` on one small volume."""
    cfg, _jm, variables = jax_unet(SMALL, (40, 40, 8))
    path = str(tmp_path / "jax.hcunet")
    jckpt.save_checkpoint(path, variables, JaxUNetConfig(**SMALL))
    tiles = dict(eval_size=(16, 24, 8), pad=(16, 16, 2), batch=4)
    vol = np.random.default_rng(3).random((20, 30, 9, 4), np.float32)
    import hcunet_tpu.config as J

    want = JaxSegmenter.from_checkpoint(path, tile_cfg=J.TileConfig(**tiles)).predict(vol)
    got = Segmenter.from_checkpoint(path, tile_cfg=TileConfig(**tiles), device="cpu").predict(vol)
    assert got.shape == want.shape == vol.shape[:-1]
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def unet_g2():
    return jax_unet(SMALL_G2, TRAIN_SPATIAL)


TX = {"adam": dict(learning_rate=2e-3),
      "adamw_gamma": dict(learning_rate=2e-3, weight_decay=0.05, gamma=0.5, steps_per_epoch=2)}


@pytest.mark.parametrize("tx", list(TX))
def test_training_state_crosses_both_ways(tmp_path, unet_g2, tx):
    """2 steps in one package, its training state resumed by the other for
    2 more, against 4 steps in the other alone: the resumed trajectory
    matches (``assert_trajectories_match``), in both directions."""
    cfg, jmodel, variables = unet_g2
    kw = dict(TX[tx], log_every=0)
    batches = [train_batch(s) for s in range(4)]
    path = str(tmp_path / "state.msgpack")

    def jax_trainer():
        return JaxUNetTrainer(jmodel, variables, JaxTrainConfig(**kw))

    def port_trainer():
        return UNetTrainer(port_unet(cfg, variables), cfg=TrainConfig(**kw), device="cpu")

    for first, second in ((port_trainer, jax_trainer), (jax_trainer, port_trainer)):
        a = first()
        for b in batches[:2]:
            a.train_step(*b)
        a.save_training_state(path)
        resumed, alone = second(), second()
        resumed.load_training_state(path)
        for b in batches[:2]:
            alone.train_step(*b)
        for b in batches[2:]:
            lr_, la = resumed.train_step(*b), alone.train_step(*b)
            assert abs(lr_ - la) <= 1e-5 * la, (lr_, la)
        assert_trajectories_match(jax.tree.map(np.asarray, resumed.variables),
                                  jax.tree.map(np.asarray, alone.variables), variables,
                                  kw["learning_rate"], 4)


@pytest.mark.parametrize("tx", list(TX))
def test_port_resume_is_exact(tmp_path, unet_g2, tx):
    """In the port, a resumed run equals the uninterrupted one bit for bit:
    parameters, batch statistics, Adam moments and the learning rate."""
    cfg, _jm, variables = unet_g2
    kw = dict(TX[tx], log_every=0)
    batches = [train_batch(s) for s in range(4)]
    path = str(tmp_path / "state.msgpack")
    alone = UNetTrainer(port_unet(cfg, variables), cfg=TrainConfig(**kw), device="cpu")
    first = UNetTrainer(port_unet(cfg, variables), cfg=TrainConfig(**kw), device="cpu")
    for b in batches[:2]:
        first.train_step(*b)
    first.save_training_state(path)
    resumed = UNetTrainer(port_unet(cfg, jax_unet(SMALL_G2, TRAIN_SPATIAL, seed=5)[2]),
                          cfg=TrainConfig(**kw), device="cpu")
    resumed.load_training_state(path)
    for b in batches:
        alone.train_step(*b)
    for b in batches[2:]:
        resumed.train_step(*b)
    for k, v in alone.model.state_dict().items():
        assert torch.equal(v, resumed.model.state_dict()[k]), k
    _same_tree(flat(alone.opt_state), flat(resumed.opt_state))
    assert alone.opt.param_groups[0]["lr"] == resumed.opt.param_groups[0]["lr"]
    with pytest.raises(ValueError, match="optimizer chain"):
        other = dict(kw, weight_decay=0.0 if "weight_decay" in kw else 0.05)
        UNetTrainer(port_unet(cfg, variables), cfg=TrainConfig(**other),
                    device="cpu").load_training_state(path)
