"""The port's ``analyze`` (``hcunet_tpu_torch/infer/pipeline.py``) against
the JAX package's, on the CPU, with the same weights and the same volume.

The U-Net is the two-level ``SMALL`` net of ``tests/torch_port_support.py``
and the detector the small-backbone one of
``tests/test_torch_port_detection.py``, both with random weights made from a
numpy seed in the JAX variable trees and carried into the port by
``unet_state_dict_from_jax_variables`` and
``detector_state_dict_from_jax_variables``.  The volume is the bench's blob
scene at 96 x 96 x 6, cut by ``numchunks=3`` into 2 x 2 chunks, so that
instance ids are renumbered across chunks.  Tolerances:

* ``mask`` within 1e-4 (XLA's and PyTorch's float32 convolutions, BN
  folding and the blur sum in other orders; ~1e-6 is seen) plus, for a
  fixed-point transfer, one quantum (``prob_scale / (2**bits - 1)``: a value
  within 1e-6 of a rounding boundary may round either way).  Voxels whose
  value lies within 1e-5 of the floor (the one on the nonzero side: the
  other side floored it to 0) are counted and allowed to differ; none are
  expected.
* Given the JAX run's mask and candidates, the instance stage is exact.
  End to end, the cells are equal in count, centers and volumes.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcunet_tpu.benchmarks import _blob_scene
from hcunet_tpu.config import PipelineConfig as JaxPipelineConfig
from hcunet_tpu.config import TileConfig as JaxTileConfig
from hcunet_tpu.config import UNetConfig as JaxUNetConfig
from hcunet_tpu.config import WatershedConfig as JaxWatershedConfig
from hcunet_tpu.infer import pipeline as jpipeline
from hcunet_tpu.infer.detect import predict_cell_candidates as jax_predict_cell_candidates
from hcunet_tpu.infer.instance import generate_unique_segmentation_mask as jax_instance
from hcunet_tpu_torch import PipelineConfig, TileConfig, WatershedConfig, analyze
from hcunet_tpu_torch.infer import pipeline as tpipeline
from hcunet_tpu_torch.infer.compile import compile_serving_apply
from hcunet_tpu_torch.infer.instance import generate_unique_segmentation_mask
from hcunet_tpu_torch.utils.profiling import trace

from test_torch_port_detection import _detectors
from torch_port_support import SMALL, jax_unet, port_unet

SHAPE = (96, 96, 6)
TILES = dict(eval_size=(48, 48, 6), pad=(24, 24, 3), batch=2)
WATERSHED = dict(expand_mask=2)
VOLUMES = ("float32", "uint16", "uint8")
TRANSFER = {"float32": "float32", "uint16": "uint16", "uint8": "uint8"}


def _volume(dtype):
    vol16, _ = _blob_scene(*SHAPE, n_cells=12, seed=0)
    if dtype == "uint16":
        return vol16
    if dtype == "uint8":
        return (vol16 >> 8).astype(np.uint8)
    return vol16.astype(np.float32) / np.float32(65536)


@pytest.fixture(scope="module")
def models():
    cfg, jmodel, variables = jax_unet(SMALL, (48, 48, 6))
    # the output conv negated and scaled by 10: the random net's map then
    # follows the scene's blobs (correlation ~0.75 with the truth) and the
    # instance stage finds cells in it
    params = dict(variables["params"])
    params["out_kernel"] = params["out_kernel"] * np.float32(-10)
    params["out_bias"] = params["out_bias"] * np.float32(-10)
    variables = {"params": params, "batch_stats": variables["batch_stats"]}
    jdet, det_vars, tdet = _detectors("small")
    return {
        "jax_apply": jax.tree_util.Partial(
            lambda v, t: jmodel.apply(v, t, train=False), variables
        ),
        "port_apply": compile_serving_apply(
            port_unet(cfg, variables), dtype=torch.float32, device="cpu"
        ),
        "cfg": cfg,
        "jdet": jdet,
        "det_vars": det_vars,
        "tdet": tdet,
    }


def _cfgs(models, transfer):
    jcfg = JaxPipelineConfig(
        numchunks=3, unet=JaxUNetConfig(**SMALL), tiles=JaxTileConfig(**TILES),
        watershed=JaxWatershedConfig(**WATERSHED), prob_transfer_dtype=transfer,
    )
    tcfg = PipelineConfig(
        numchunks=3, unet=models["cfg"], tiles=TileConfig(**TILES),
        watershed=WatershedConfig(**WATERSHED), prob_transfer_dtype=transfer,
    )
    return jcfg, tcfg


def _port(models, volume, cfg, work, detector=True, **kw):
    return analyze(
        volume=volume, unet_apply=models["port_apply"],
        detector=models["tdet"] if detector else None, cfg=cfg, work_dir=str(work),
        fit_cochlea=False, device="cpu", **kw,
    )


@pytest.fixture(scope="module")
def runs(models, tmp_path_factory):
    """``{volume dtype: (JAX result, port result, volume, port config)}``;
    the port's work directory is ``<tmp>/<dtype>/port``."""
    out = {}
    for dtype in VOLUMES:
        vol = _volume(dtype)
        jcfg, tcfg = _cfgs(models, TRANSFER[dtype])
        root = tmp_path_factory.mktemp(dtype)
        want = jpipeline.analyze(
            volume=vol, unet_apply=models["jax_apply"], detector=models["jdet"],
            detector_variables=models["det_vars"], cfg=jcfg, work_dir=str(root / "jax"),
            fit_cochlea=False,
        )
        got = _port(models, vol, tcfg, root / "port")
        out[dtype] = (want, got, vol, tcfg)
        if dtype == "float32":
            out["csv"] = (root / "port" / "cells.csv").read_bytes()
            assert out["csv"] == (root / "jax" / "cells.csv").read_bytes()
    return out


@pytest.mark.parametrize("dtype", VOLUMES)
def test_analyze_mask_equals_jax(runs, dtype):
    want, got, vol, cfg = runs[dtype]
    assert got.mask.shape == want.mask.shape == SHAPE
    assert got.mask.dtype == want.mask.dtype == np.float32
    bits = {"uint16": 16, "uint8": 8}.get(cfg.prob_transfer_dtype)
    quantum = cfg.prob_scale / (2**bits - 1) if bits else 0.0
    floor = cfg.prob_floor * cfg.prob_scale
    diff = np.abs(got.mask - want.mask)
    hi = np.maximum(got.mask, want.mask)
    near_floor = (np.minimum(got.mask, want.mask) == 0) & (np.abs(hi - floor) <= 1e-5 * cfg.prob_scale + quantum)
    assert int(near_floor.sum()) == 0
    assert float(diff[~near_floor].max()) <= 1e-4 + quantum
    assert (want.mask > 0).mean() > 0.05  # the scene has foreground


@pytest.mark.parametrize("dtype", VOLUMES)
def test_analyze_cells_equal_jax(runs, dtype):
    want, got, vol, cfg = runs[dtype]
    assert len(got.cells) == len(want.cells) >= 3
    for g, w in zip(got.cells, want.cells):
        assert (g.unique_id, g.center, g.volume, g.image_coords) == (
            w.unique_id, w.center, w.volume, w.image_coords
        )
        np.testing.assert_allclose(g.gfp_stats["mean"], w.gfp_stats["mean"], rtol=1e-6)
    np.testing.assert_array_equal(got.unique_mask, want.unique_mask)
    assert set(got.stage_seconds) == set(want.stage_seconds)
    assert got.stage_bytes == want.stage_bytes
    assert got.stage_bytes["detect_d2h"] > 0


def test_instance_stage_on_jax_mask_and_candidates_equals_jax(runs, models):
    """Each chunk's instance stage, fed the JAX run's mask and the JAX
    detector's candidates, gives the JAX labels exactly."""
    want, _, vol, cfg = runs["float32"]
    n_labels = 0
    for x0, x1 in ((0, 48), (48, 96)):
        for y0, y1 in ((0, 48), (48, 96)):
            chunk = (vol[x0:x1, y0:y1] - np.float32(0.5)) / np.float32(0.5)
            cand = jax_predict_cell_candidates(
                chunk[..., list(cfg.detection_channels)], models["jdet"], models["det_vars"]
            )
            prob = want.mask[x0:x1, y0:y1]
            jl, js = jax_instance(prob, cand, JaxWatershedConfig(**WATERSHED))
            tl, ts = generate_unique_segmentation_mask(prob, cand, WatershedConfig(**WATERSHED))
            np.testing.assert_array_equal(tl, jl)
            np.testing.assert_array_equal(ts, js)
            n_labels += len(np.unique(tl)) - 1
    assert n_labels > 0


def test_encode_fixed_equals_jax_at_half_quanta():
    """The fixed-point encode rounds half to even like ``jnp.round``: the
    JAX package's ``_encode_fixed`` (``pipeline.py:385-392``, a closure
    there, so written out here as it stands) on values whose scaled value
    is exactly k + 1/2, and on a sweep."""
    scale = 10.0

    @jax.jit
    def jax_encode16(prob):
        qmax = float(2**16 - 1)
        q = jnp.clip(prob * (qmax / scale), 0.0, qmax)
        return jnp.round(q).astype(jnp.uint16)

    @jax.jit
    def jax_encode8(prob):
        qmax = float(2**8 - 1)
        q = jnp.clip(prob * (qmax / scale), 0.0, qmax)
        return jnp.round(q).astype(jnp.uint8)

    for bits, jfn in ((16, jax_encode16), (8, jax_encode8)):
        qmax = 2**bits - 1
        k = np.arange(0, qmax, max(1, qmax // 997), dtype=np.float64)
        halves = ((k + 0.5) * scale / qmax).astype(np.float32)
        sweep = np.linspace(-0.5, scale + 0.5, 20001, dtype=np.float32)
        prob = np.concatenate([halves, sweep])
        scaled = prob * np.float32(qmax / scale)
        assert (scaled == np.floor(scaled) + 0.5).sum() > 100  # exact half-quanta hit
        got = tpipeline._encode_fixed(torch.from_numpy(prob), scale, bits).numpy()
        if bits == 16:
            got = got.view(np.uint16)
        np.testing.assert_array_equal(got, np.asarray(jfn(jnp.asarray(prob))))


@pytest.mark.parametrize("overlap, traced", [
    pytest.param(False, False, id="False"),
    pytest.param(1, False, id="1"),
    pytest.param(2, False, id="2"),
    pytest.param(2, True, id="2-traced"),
])
def test_overlap_gives_the_same_results(runs, models, tmp_path, overlap, traced):
    """``traced``: the run under ``utils/profiling.py::trace`` (as
    ``analyze --trace``), whose trace holds each stage's span
    ``hcunet.analyze.<stage>``, the chunk tails' on the tail workers'
    threads, while ``stage_seconds`` counts the same stages."""
    want, _, vol, cfg = runs["float32"]
    if traced:
        with trace(str(tmp_path / "trace")):
            got = _port(models, vol, cfg, tmp_path / "work", overlap=overlap)
        (name,) = os.listdir(tmp_path / "trace")
        with open(tmp_path / "trace" / name) as f:
            events = json.load(f)["traceEvents"]
        stages = {}
        for ev in events:
            if ev.get("ph") == "X" and ev.get("name", "").startswith("hcunet.analyze."):
                stages.setdefault(ev["name"].rsplit(".", 1)[1], set()).add(ev["tid"])
        assert set(stages) == set(got.stage_seconds) == {"detect", "unet", "instance",
                                                         "analytics"}
        # the instance stage runs on the tail workers, the U-Net on the caller
        assert not stages["instance"] & stages["unet"]
        assert all(v > 0 for v in got.stage_seconds.values())
    else:
        got = _port(models, vol, cfg, tmp_path / "work", overlap=overlap)
    np.testing.assert_array_equal(got.mask, runs["float32"][1].mask)
    np.testing.assert_array_equal(got.unique_mask, runs["float32"][1].unique_mask)
    assert [(c.unique_id, c.center, c.volume) for c in got.cells] == [
        (c.unique_id, c.center, c.volume) for c in want.cells
    ]
    assert (tmp_path / "work" / "cells.csv").read_bytes() == runs["csv"]


def test_resumes_from_journal(models, tmp_path):
    vol = _volume("float32")
    _, cfg = _cfgs(models, "float32")
    work = tmp_path / "work"
    first = _port(models, vol, cfg, work)
    parts_before = sorted(os.listdir(work))

    def boom(*a, **k):
        raise AssertionError("the U-Net must not run on resume")

    again = analyze(volume=vol, unet_apply=boom, detector=None, cfg=cfg, work_dir=str(work),
                    fit_cochlea=False, device="cpu")
    assert sorted(os.listdir(work)) == parts_before
    np.testing.assert_array_equal(again.mask, first.mask)
    np.testing.assert_array_equal(again.unique_mask, first.unique_mask)
    assert [(c.unique_id, c.center) for c in again.cells] == [
        (c.unique_id, c.center) for c in first.cells
    ]


def test_work_dir_fingerprint_guard(models, tmp_path):
    _, cfg = _cfgs(models, "float32")
    vol_a = _volume("float32")
    vol_b = vol_a[::-1].copy()
    _port(models, vol_a, cfg, tmp_path, detector=False)
    with pytest.raises(ValueError, match="different"):
        _port(models, vol_b, cfg, tmp_path, detector=False)
    assert tpipeline._volume_fingerprint(vol_a, 3) == jpipeline._volume_fingerprint(vol_a, 3)


def test_analyze_needs_cuda_unless_cpu(models, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = _cfgs(models, "float32")
    kw = dict(volume=_volume("float32"), unet_apply=models["port_apply"], cfg=cfg,
              work_dir=str(tmp_path / "w"), fit_cochlea=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        analyze(**kw)
    with pytest.raises(TypeError, match="mesh"):
        analyze(mesh=object(), device="cpu", **kw)
    assert not os.path.exists(tmp_path / "w")


def test_pipeline_config_equals_jax():
    assert dataclasses.asdict(PipelineConfig()) == dataclasses.asdict(JaxPipelineConfig())
