"""The reduction of a profiler trace to the window's busy time, its idle
gaps by what the host did, its device operations, and the readers built
on them."""

from __future__ import annotations

import json

import pytest

from portbench import trace as tracing
from portbench.readers import copy_share_pct, idle_pct


def _trace(tmp_path):
    events = [
        {"ph": "X", "cat": "user_annotation", "name": tracing.WINDOW_SPAN, "ts": 0, "dur": 100, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 10, "dur": 30, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv", "ts": 50, "dur": 10, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "other thread", "ts": 0, "dur": 100, "tid": 2},
        {"ph": "X", "cat": "kernel", "name": "conv3d_valid_kernel<float>", "ts": 0, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)", "ts": 20, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD (Device -> Device)", "ts": 25, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "conv3d_valid_kernel<float>", "ts": 60, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "wgrad_engine", "ts": 70, "dur": 40},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return tracing.parse(str(path))


def test_busy_idle_and_gaps(tmp_path):
    t = _trace(tmp_path)
    assert t.window_s == pytest.approx(100e-6)
    # busy: [0, 10], [20, 35], [60, 100] (the last kernel clipped to the window)
    assert t.busy_s() == pytest.approx(65e-6)
    assert t.kernel_s("conv3d_valid") == pytest.approx(30e-6)
    assert t.kernel_count("conv3d_valid") == 2
    gaps = dict(t.idle_gaps())
    # [10, 20] and [35, 60] start inside aten::copy_ (the innermost of the
    # harness thread's events there); the other thread's event is not read
    assert gaps == {"aten::copy_": pytest.approx(35e-6)}
    ops = dict(t.device_ops())
    assert ops["wgrad_engine"] == pytest.approx(30e-6)


def test_readers_on_a_trace(tmp_path):
    obs = type("Obs", (), {"trace": _trace(tmp_path)})()
    assert idle_pct(obs) == pytest.approx(35.0)
    # only host<->device copies count
    assert copy_share_pct(obs) == pytest.approx(10.0)
    assert tracing.union_s([(0, 10), (5, 20), (30, 31)]) == pytest.approx(21e-6)
