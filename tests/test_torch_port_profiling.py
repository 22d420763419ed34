"""The port's profiling hooks (``hcunet_tpu_torch/utils/profiling.py``), the
twins of ``tests/test_profiling.py``."""

import os

import numpy as np
import pytest
import torch

from hcunet_tpu_torch.utils.profiling import (
    assert_finite,
    device_sync,
    enable_nan_checks,
    timed,
    trace,
)


def test_timed_and_device_sync():
    x = torch.ones((64, 64))
    with timed("matmul", sync=None) as t0:
        y = x @ x
    with timed("matmul", sync={"y": y, "n": [np.ones(2)]}) as t1:
        y = x @ x
    assert t1.seconds >= 0 and t0.seconds >= 0
    device_sync([y, {"a": y}])  # no CUDA tensor: nothing to wait for


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
