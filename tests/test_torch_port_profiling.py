"""The port's profiling hooks (``hcunet_tpu_torch/utils/profiling.py``), the
twins of ``tests/test_profiling.py``, and the spans of the serving paths:
``Segmenter.predict`` and the recurrent serving forward, on the CPU at small
sizes."""

import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hcunet_tpu_torch.config import RUNetConfig, TileConfig, UNetConfig
from hcunet_tpu_torch.infer.compile_recurrent import compile_recurrent_apply
from hcunet_tpu_torch.infer.serving import Segmenter
from hcunet_tpu_torch.models.runet import RecursiveUNet
from hcunet_tpu_torch.models.unet import UNet
from hcunet_tpu_torch.utils.profiling import (
    assert_finite,
    enable_nan_checks,
    span,
    trace,
)
from tests.torch_port_support import SMALL

TILE = dict(eval_size=(16, 24, 8), pad=(16, 16, 2), batch=4)
# buckets to (48, 72, 16) by symmetric padding
VOLUME = (40, 50, 9)
RECURRENT = (16, 16, 5)


@pytest.fixture(scope="module")
def segmenter():
    torch.manual_seed(0)
    return Segmenter(UNet(UNetConfig(**SMALL)), tile_cfg=TileConfig(**TILE), device="cpu")


@pytest.fixture(scope="module")
def recurrent():
    torch.manual_seed(0)
    cfg = RUNetConfig(timesteps=3)
    apply = compile_recurrent_apply(RecursiveUNet(cfg).eval(), dtype=torch.float32, device="cpu")
    return cfg, apply


def _volume():
    return np.random.default_rng(3).random((*VOLUME, 4), dtype=np.float32)


def _spans(prof):
    """``(name, start_us, end_us, thread)`` of the trace's ``hcunet.``
    ranges, in start order."""
    found = [(e.name, e.time_range.start, e.time_range.end, e.thread)
             for e in prof.events() if e.name.startswith("hcunet.")]
    return sorted(found, key=lambda ev: (ev[1], -ev[2]))


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2] and inner[3] == outer[3]


def test_span_enters_no_record_function_without_a_profiler(segmenter, recurrent, monkeypatch):
    """With no profiler collecting, a span is one shared no-op context, and
    the serving paths enter no ``record_function``."""

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with span("hcunet.test"):
        pass
    assert span("hcunet.a") is span("hcunet.b")
    segmenter.predict(_volume())
    recurrent[1](torch.ones((1, *RECURRENT, 4)))


def test_segmenter_predict_spans(segmenter):
    """A bucket-padded ``predict`` under the profiler: the upload of the
    unpadded volume, the bucket pad on the device, the tiles and the
    read-back, in that order, inside ``hcunet.serve.predict`` on one
    thread, and the same mask as without the profiler."""
    vol = _volume()
    want = segmenter.predict(vol)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = segmenter.predict(vol)
    np.testing.assert_array_equal(got, want)
    spans = _spans(prof)
    assert [s[0] for s in spans] == [
        "hcunet.serve.predict", "hcunet.tiling.upload", "hcunet.serve.bucket_pad",
        "hcunet.tiling.tiles", "hcunet.serve.readback",
    ]
    assert all(_inside(s, spans[0]) for s in spans[1:])
    assert all(a[2] <= b[1] for a, b in zip(spans[1:], spans[2:]))  # one after another


def test_recurrent_apply_spans(recurrent):
    """The recurrent serving forward under the profiler: one
    ``hcunet.recurrent.forward`` holding the upload and ``timesteps``
    timestep spans, and the same head as without the profiler."""
    cfg, apply = recurrent
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, *RECURRENT, 4)).astype(np.float32))
    want = apply(x)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = apply(x)
    assert torch.equal(got, want)
    spans = _spans(prof)
    names = [s[0] for s in spans]
    assert names == (["hcunet.recurrent.forward", "hcunet.recurrent.upload"]
                     + ["hcunet.recurrent.timestep"] * cfg.timesteps)
    assert all(_inside(s, spans[0]) for s in spans[1:])


def test_assert_finite_names_bad_leaf():
    good = {"a": torch.ones(3), "b": {"c": np.zeros(2)}}
    assert_finite(good, "params")  # no raise
    bad = {"a": torch.ones(3), "b": {"c": torch.tensor([1.0, float("nan")])}}
    with pytest.raises(FloatingPointError, match="b.*c"):
        assert_finite(bad, "params")
    with pytest.raises(FloatingPointError, match="params/1"):
        assert_finite([np.ones(2), np.asarray([np.inf])], "params")


def test_trace_writes_profile(tmp_path):
    with trace(str(tmp_path)):
        _ = (torch.ones((32, 32)) @ torch.ones((32, 32))).sum()
    found = [f for _root, _dirs, files in os.walk(tmp_path) for f in files]
    assert found, "profiler trace produced no files"
    assert all(f.endswith(".json") and os.path.getsize(tmp_path / f) > 0 for f in found)


def test_enable_nan_checks_is_autograd_anomaly_mode():
    try:
        enable_nan_checks(True)
        assert torch.is_anomaly_enabled()
        x = torch.tensor([-1.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).sum().backward()
    finally:
        enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()
