"""The device's idle time credited to the program's spans
(:mod:`portbench.spans`): on synthetic chrome traces, and on the spans a
small traced run of the program opens on the CPU."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest

from portbench import bench, spans, trace as tracing
from portbench.tests.conftest import SMALL


def _trace(tmp_path, host, device, window=(0, 100)):
    """A parsed trace of host events ``(name, start, end)`` on the
    harness's thread, one event on another thread, and device events
    ``(cat, name, start, end)``, in microseconds."""
    events = [{"ph": "X", "cat": "user_annotation", "name": tracing.WINDOW_SPAN,
               "ts": window[0], "dur": window[1] - window[0], "tid": 1}]
    events += [{"ph": "X", "cat": "user_annotation", "name": n, "ts": s, "dur": e - s, "tid": 1}
               for n, s, e in host]
    events.append({"ph": "X", "cat": "user_annotation", "name": "hcunet.serve.bucket_pad",
                   "ts": 0, "dur": 100, "tid": 2})
    events += [{"ph": "X", "cat": c, "name": n, "ts": s, "dur": e - s} for c, n, s, e in device]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return tracing.parse(str(path))


def _obs(trace, requests=1):
    return SimpleNamespace(trace=trace, requests=[None] * requests)


# two requests: the first's read-back copy, then the second's predict; the
# card idles over [10, 12] and [25, 75]
MIXED_HOST = [
    (tracing.REQUEST_SPAN, 0, 30), ("aten::copy_", 12, 30),
    (tracing.REQUEST_SPAN, 30, 100), ("hcunet.serve.predict", 31, 100),
    ("hcunet.serve.bucket_pad", 32, 70), ("hcunet.tiling.upload", 72, 80),
    ("aten::copy_", 73, 80), ("hcunet.tiling.tiles", 80, 100),
]
MIXED_DEVICE = [
    ("kernel", "conv3d_valid_ring_kernel", 0, 10),
    ("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 12, 25),
    ("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 75, 80),
    ("kernel", "conv3d_valid_ring_kernel", 80, 100),
]


def test_a_gap_from_a_copy_through_the_pad(tmp_path):
    """A gap that opens inside the previous request's ``aten::copy_`` and
    runs on through the next request's bucket pad: ``idle_gaps`` books all
    of it to ``aten::copy_``, the spans credit the pad with its overlap."""
    t = _trace(tmp_path, MIXED_HOST, MIXED_DEVICE)
    assert spans.idle_intervals(t) == [[10, 12], [25, 75]]
    gaps = dict(t.idle_gaps())
    assert gaps["aten::copy_"] == pytest.approx(50e-6)
    assert "hcunet.serve.bucket_pad" not in gaps
    obs = _obs(t, requests=2)
    # [32, 70] of [25, 75], over two requests
    assert spans.idle_ms_per_request(obs, "hcunet.serve.bucket_pad") == pytest.approx(0.019)
    assert spans.idle_ms_per_request(obs, "hcunet.tiling.upload") == pytest.approx(0.0015)
    assert spans.idle_ms_per_request(obs, "hcunet.tiling.tiles") == 0.0
    # [31, 75] of the 52 us idle
    assert spans.idle_in_program_pct(obs, "hcunet.serve.predict") == pytest.approx(
        100 * 44 / 52)


def test_nested_spans_count_once(tmp_path):
    """Instances of one span nested in one another, or overlapping, count
    once; instances reaching past the window are clipped to it."""
    host = [("hcunet.recurrent.timestep", 10, 50), ("hcunet.recurrent.timestep", 20, 40),
            ("hcunet.recurrent.timestep", 45, 60), ("hcunet.recurrent.timestep", 90, 130)]
    device = [("kernel", "k", 0, 30), ("kernel", "k", 55, 95)]
    t = _trace(tmp_path, host, device)
    assert spans.span_union(t, "hcunet.recurrent.timestep") == [[10, 60], [90, 100]]
    # idle [30, 55] and [95, 100], all of it inside the timesteps' 60 us
    assert spans.idle_inside_us(t, "hcunet.recurrent.timestep") == pytest.approx(30)
    assert spans.idle_share_of_span_pct(_obs(t), "hcunet.recurrent.timestep") == pytest.approx(
        50.0)


@pytest.mark.parametrize("requests", [1, 4])
def test_per_request_normalisation(tmp_path, requests):
    """Idle ms a request is the idle time inside the span over the requests
    the window served; the shares do not depend on the count."""
    t = _trace(tmp_path, MIXED_HOST, MIXED_DEVICE)
    obs = _obs(t, requests)
    assert spans.idle_ms_per_request(obs, "hcunet.serve.bucket_pad") == pytest.approx(
        0.038 / requests)
    assert spans.idle_in_program_pct(obs, "hcunet.serve.predict") == pytest.approx(100 * 44 / 52)
    assert spans.idle_ms_per_request(_obs(t, 0), "hcunet.serve.bucket_pad") is None


def test_none_without_the_span(tmp_path):
    """A window without the span, with the span only on another thread or
    outside the window, or without device events, reads None, not 0."""
    host = [("aten::copy_", 10, 20), ("hcunet.serve.readback", 120, 130)]
    t = _trace(tmp_path, host, MIXED_DEVICE)
    obs = _obs(t, 2)
    for name in ("hcunet.serve.readback", "hcunet.serve.bucket_pad", "hcunet.tiling.upload"):
        assert spans.idle_ms_per_request(obs, name) is None
    assert spans.idle_in_program_pct(obs, "hcunet.serve.predict") is None
    assert spans.idle_share_of_span_pct(obs, "hcunet.recurrent.timestep") is None
    bare = _trace(tmp_path, MIXED_HOST, [])
    assert spans.idle_ms_per_request(_obs(bare), "hcunet.serve.bucket_pad") is None
    assert spans.idle_in_program_pct(_obs(bare), "hcunet.serve.predict") is None


# the spans each cell's new metrics read, the outer one first
CELL_SPANS = {
    "unet3d-bf16-predict-mixed": ["hcunet.serve.predict", "hcunet.serve.bucket_pad",
                                  "hcunet.tiling.upload", "hcunet.tiling.tiles",
                                  "hcunet.serve.readback"],
    "runet-bf16-b1-256": ["hcunet.recurrent.forward", "hcunet.recurrent.upload",
                          "hcunet.recurrent.timestep"],
}


@pytest.mark.parametrize("workload", sorted(CELL_SPANS))
def test_the_program_opens_the_spans_the_metrics_read(workload, monkeypatch):
    """A small traced run of the cell on the CPU: every span its metrics read
    is on the harness's thread inside the window, once a request (the
    timestep once a timestep), each inside the outer span; with one device
    event in the trace, each of the cell's span metrics reads a number and,
    in the mixed cell, the four stages cover 90 % of the idle time inside
    ``hcunet.serve.predict``."""
    seen = []
    export = tracing.export
    monkeypatch.setattr(tracing, "export", lambda prof: seen.append(export(prof)) or seen[-1])
    result = bench.run_cell(workload, 2**31 + 79, 0.3, True, device="cpu",
                            overrides=SMALL[workload])
    assert result["correct"]
    (t,) = seen
    n = result["attempted"]
    names = CELL_SPANS[workload]
    per_request = {name: 1 for name in names}
    if workload == "runet-bf16-b1-256":
        per_request["hcunet.recurrent.timestep"] = SMALL[workload]["config"]["timesteps"]
    t0, t1 = t.window
    for name in names:
        found = [(s, s + d) for h, s, d in t.host if h == name and t0 <= s and s + d <= t1]
        assert len(found) == per_request[name] * n, name
    outer = spans.span_union(t, names[0])
    for name in names[1:]:
        inner = spans.span_union(t, name)
        assert spans.overlap_us(inner, outer) == pytest.approx(sum(e - s for s, e in inner))

    t.device.append(("kernel", "k", t0, 1.0))
    obs = SimpleNamespace(trace=t, requests=[None] * n)
    cell = bench.resolve(bench.load_spec(), workload)
    read = {m["name"]: bench.load_module(bench.metric_path(m["name"])).read(obs)
            for m in cell.per_layer if m["name"].split(".")[0] in (
                "pad_idle_ms", "upload_idle_ms", "tiles_idle_ms", "readback_idle_ms",
                "idle_in_program_pct", "timestep_idle_pct")}
    assert len(read) == {"unet3d-bf16-predict-mixed": 5, "runet-bf16-b1-256": 3}[workload]
    assert all(v is not None and v >= 0 for v in read.values()), read
    if workload == "unet3d-bf16-predict-mixed":
        inside = spans.idle_inside_us(t, "hcunet.serve.predict")
        stages = sum(spans.idle_inside_us(t, name) for name in names[1:])
        assert stages >= 0.9 * inside
