"""The port's benchmark module (``hcunet_tpu_torch.benchmarks``) on the CPU.

The scheduler is process and timer logic, tested with cheap fake metric
children as ``tests/test_bench_budget.py`` tests the JAX one; the metrics
run on the card only, so here they run at a tiny size with
``device="cpu"`` for their records, and their parts are held to the JAX
twin: the scene bit for bit, the fit after 3 steps by the trajectory rule
of ``hcunet_tpu_torch.train.parity``, and the headline's synced sum within
``test_torch_port_tiling.py``'s 1e-5 a voxel.
"""

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcunet_tpu import benchmarks as jbench
from hcunet_tpu.config import TileConfig as JaxTileConfig
from hcunet_tpu.infer.tiling import predict_segmentation_mask as jax_predict_segmentation_mask
from hcunet_tpu_torch import benchmarks as bench
from hcunet_tpu_torch.config import DetectorConfig, RUNetConfig, TileConfig, UNetConfig
from hcunet_tpu_torch.infer.compile import compile_serving_apply
from hcunet_tpu_torch.models.detection import Detector
from hcunet_tpu_torch.train.trainer import UNetTrainer
from hcunet_tpu_torch.utils.port_jax import jax_variables_from_unet_state_dict
from tests.torch_port_support import SMALL, assert_trajectories_match, jax_unet, port_unet

METRICS = ["tiled_unet3d_inference", "recurrent_packed_serving", "analyze_pipeline_end_to_end"]


def _parse_lines(capsys):
    out = capsys.readouterr().out
    return [json.loads(line) for line in out.splitlines() if line.strip()]


# --- _timed_reps -------------------------------------------------------------


@pytest.mark.parametrize("case", ["no_deadline", "tight_deadline", "deadline_passed"])
def test_timed_reps(case):
    """Best-of-3 with no deadline; best-of-1 when the next rep would not
    fit, and at least one rep even with the deadline already past."""
    calls = []
    if case == "no_deadline":
        best, reps = bench._timed_reps(lambda: calls.append(1), deadline=None)
        assert reps == 3 and len(calls) == 3 and best >= 0.0
    elif case == "tight_deadline":
        best, reps = bench._timed_reps(lambda: time.sleep(0.05),
                                       deadline=time.monotonic() + 0.06)
        assert reps == 1 and best >= 0.05
    else:
        _best, reps = bench._timed_reps(lambda: time.sleep(0.01),
                                        deadline=time.monotonic() - 1.0)
        assert reps == 1


# --- job selection -----------------------------------------------------------


def test_select_jobs_default_is_all_three():
    assert [m for m, _f, _fn in bench._select_jobs([])] == METRICS


def test_select_jobs_flags_compose_and_dedupe():
    metrics = [m for m, _f, _fn in bench._select_jobs(["--recurrent", "--headline", "--plain"])]
    assert metrics.count("tiled_unet3d_inference") == 1
    assert "recurrent_packed_serving" in metrics


# --- the metric-child runner (real subprocesses, cheap commands) -------------


def _child(code):
    return [sys.executable, "-u", "-c", code]


PRINT_M = "import json; print(json.dumps({'metric': 'm', 'value': 1}), flush=True)"


@pytest.mark.parametrize("case", ["result_line", "hung", "result_then_hung"])
def test_run_metric_child(capsys, case):
    """A child's result line is streamed as it comes (before the child
    exits, so that a child killed later keeps it); a child past its slice
    plus the grace is killed (rc None)."""
    t0 = time.monotonic()
    if case == "result_line":
        ok, _dur, rc = bench._run_metric_child("m", "--x", slice_s=10.0, _cmd=_child(PRINT_M))
        assert ok and rc == 0
        assert _parse_lines(capsys) == [{"metric": "m", "value": 1}]
    elif case == "hung":
        ok, _dur, rc = bench._run_metric_child(
            "m", "--x", slice_s=0.2, _grace=0.3, _cmd=_child("import time; time.sleep(60)"))
        assert not ok and rc is None
        assert _parse_lines(capsys) == []
    else:
        ok, _dur, rc = bench._run_metric_child(
            "m", "--x", slice_s=0.5, _grace=2.0,
            _cmd=_child(PRINT_M + "; import time; time.sleep(60)"))
        assert ok and rc is None
        assert _parse_lines(capsys) == [{"metric": "m", "value": 1}]
    assert time.monotonic() - t0 < 10.0


# --- the scheduler -----------------------------------------------------------


@pytest.fixture
def sched_env(monkeypatch, tmp_path):
    """Isolate run(): one card, the ledger in tmp, children faked per test."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("HCUNET_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("HCUNET_NO_CACHE", raising=False)
    monkeypatch.delenv(bench._CHILD_ENV, raising=False)
    return monkeypatch


def _fake_child(value=1.0, dur=2.0, ran=None):
    def child(metric, flag, slice_s, **kw):
        if ran is not None:
            ran.append((metric, slice_s))
        print(json.dumps({"metric": metric, "value": value}), flush=True)
        return True, dur, 0
    return child


def test_run_all_metrics_within_budget(sched_env, capsys):
    ran = []
    sched_env.setattr(bench, "_run_metric_child", _fake_child(ran=ran))
    sched_env.setenv("HCUNET_BENCH_BUDGET_S", "600")
    assert bench.run([]) == 0
    assert [rec["metric"] for rec in _parse_lines(capsys)] == METRICS
    # the ledger recorded the observed durations
    assert bench._load_ledger() == {m: {"s": 2.0, "ok": True} for m, _s in ran}


@pytest.mark.parametrize("case", ["zero_budget", "killed_child"])
def test_run_emits_explicit_skips(sched_env, capsys, case):
    """No budget: every metric skipped, no child run.  A child killed
    before it printed: a skip line, not silence.  Both exit 0."""
    if case == "zero_budget":
        sched_env.setattr(bench, "_run_metric_child",
                          lambda *a, **kw: pytest.fail("child must not run with no budget"))
        sched_env.setenv("HCUNET_BENCH_BUDGET_S", "1")
        argv, want = [], METRICS
    else:
        sched_env.setattr(bench, "_run_metric_child", lambda m, f, s, **kw: (False, s, None))
        sched_env.setenv("HCUNET_BENCH_BUDGET_S", "600")
        argv, want = ["--headline"], METRICS[:1]
    assert bench.run(argv) == 0
    lines = _parse_lines(capsys)
    assert [rec["metric"] for rec in lines] == want
    assert all(rec["skipped"] == "budget" for rec in lines)


def test_known_slow_pipeline_runs_last_with_remaining_budget(sched_env, capsys):
    """The pipeline runs last, so a known-long ledger estimate does not
    starve the cheap metrics, and it still gets every second left."""
    bench._save_ledger({"analyze_pipeline_end_to_end": 500.0})
    ran = []
    sched_env.setattr(bench, "_run_metric_child", _fake_child(ran=ran))
    sched_env.setenv("HCUNET_BENCH_BUDGET_S", "300")
    assert bench.run([]) == 0
    lines = _parse_lines(capsys)
    assert [r["metric"] for r in lines] == METRICS
    assert all("value" in r for r in lines)
    assert ran[-1][0] == "analyze_pipeline_end_to_end"
    assert ran[-1][1] > 250


def test_run_last_metric_runs_even_if_ledger_says_slow(sched_env, capsys):
    bench._save_ledger({"recurrent_packed_serving": 250.0})
    sched_env.setattr(bench, "_run_metric_child", _fake_child(value=3.0, dur=100.0))
    sched_env.setenv("HCUNET_BENCH_BUDGET_S", "400")
    assert bench.run(["--recurrent"]) == 0
    assert _parse_lines(capsys)[0] == {"metric": "recurrent_packed_serving", "value": 3.0}


def test_run_without_a_card_times_nothing(sched_env, capsys):
    """No CUDA device: one ``no_cuda_device`` line per metric, exit code 1,
    and neither a child nor a timing."""
    sched_env.setattr(torch.cuda, "device_count", lambda: 0)
    sched_env.setattr(bench, "_run_metric_child",
                      lambda *a, **kw: pytest.fail("no child without a card"))
    sched_env.setattr(bench, "_timed_reps", lambda *a, **kw: pytest.fail("nothing is timed"))
    sched_env.setenv("HCUNET_BENCH_BUDGET_S", "600")
    assert bench.run([]) == 1
    assert _parse_lines(capsys) == [{"metric": m, "error": "no_cuda_device"} for m in METRICS]


def test_run_child_exception_is_reported_and_run_continues(sched_env, capsys):
    calls = []

    def fake_child(metric, flag, slice_s, **kw):
        calls.append(metric)
        if metric == "tiled_unet3d_inference":
            return False, 1.0, 1  # the child failed with a traceback
        print(json.dumps({"metric": metric, "value": 1.0}), flush=True)
        return True, 1.0, 0

    sched_env.setattr(bench, "_run_metric_child", fake_child)
    sched_env.setenv("HCUNET_BENCH_BUDGET_S", "600")
    assert bench.run([]) == 1
    by_metric = {rec["metric"]: rec for rec in _parse_lines(capsys)}
    assert by_metric["tiled_unet3d_inference"]["error"] == "exception"
    assert len(calls) == 3  # the failure did not stop the schedule
    assert "tiled_unet3d_inference" not in bench._load_ledger()


def test_child_mode_dispatches_single_metric_with_float32_pinned(monkeypatch, capsys):
    monkeypatch.setenv(bench._CHILD_ENV, "1")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    seen = []

    def fake_main():
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        print(json.dumps({"metric": "tiled_unet3d_inference", "value": 9.0}), flush=True)

    monkeypatch.setattr(bench, "main", fake_main)
    assert bench.run(["--headline"]) == 0
    assert _parse_lines(capsys) == [{"metric": "tiled_unet3d_inference", "value": 9.0}]
    assert seen == [(False, False)]


def test_child_mode_lets_an_exception_through(monkeypatch):
    """A child's failure is a traceback and a non-zero exit; the parent
    prints the ``exception`` line."""
    monkeypatch.setenv(bench._CHILD_ENV, "1")

    def boom():
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(bench, "main", boom)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        bench.run(["--headline"])


# --- the three repairs of the JAX bench's faults -----------------------------


def test_killed_child_with_result_is_a_lower_bound(sched_env, capsys):
    """A child that printed its value and then hung is killed: its line
    stands, and the ledger keeps its time as a lower bound (``ok`` False),
    never as a completed run."""
    real = bench._run_metric_child
    sched_env.setattr(bench, "_run_metric_child", lambda m, f, s, **kw: real(
        m, f, 0.5, _grace=1.0,
        _cmd=_child(f"import json, time; print(json.dumps({{'metric': '{m}', 'value': 2}}), "
                    "flush=True); time.sleep(60)")))
    sched_env.setenv("HCUNET_BENCH_BUDGET_S", "600")
    assert bench.run(["--headline"]) == 0
    assert _parse_lines(capsys) == [{"metric": "tiled_unet3d_inference", "value": 2}]
    entry = bench._load_ledger()["tiled_unet3d_inference"]
    assert entry["ok"] is False and entry["s"] >= 1.5


def test_run_stays_within_the_budget(sched_env, capsys):
    """Children that hang are killed at their slice plus the grace, and the
    slice is cut so that the kill falls inside the budget: the whole run
    ends within ``HCUNET_BENCH_BUDGET_S`` (the JAX bench could overrun it by
    ``GRACE_S - RESERVE_S``)."""
    real = bench._run_metric_child
    sched_env.setattr(bench, "GRACE_S", 3.0)
    sched_env.setattr(bench, "RESERVE_S", 1.0)
    sched_env.setattr(bench, "MIN_SLICE_S", 0.5)
    sched_env.setattr(bench, "_run_metric_child", lambda m, f, s, **kw: real(
        m, f, s, _cmd=_child("import time; time.sleep(60)")))
    sched_env.setenv("HCUNET_BENCH_BUDGET_S", "6")
    t0 = time.monotonic()
    assert bench.run(["--headline"]) == 0
    wall = time.monotonic() - t0
    assert wall <= 6.0 + 1.0, wall
    assert [rec["skipped"] for rec in _parse_lines(capsys)] == ["budget"]


def test_ledger_that_does_not_load_is_dropped(sched_env):
    path = bench._ledger_path()
    with open(path, "w") as f:
        f.write('{"tiled_unet3d_inference": {"s": 1')  # cut short
    assert bench._load_ledger() == {}
    assert not os.path.exists(path)
    bench._save_ledger({"m": {"s": 1.0, "ok": True}})
    assert bench._load_ledger() == {"m": {"s": 1.0, "ok": True}}
    assert [n for n in os.listdir(os.path.dirname(path)) if n.startswith(".tmp_")] == []


def test_fit_cache_is_atomic_and_refits_a_truncated_file(monkeypatch, tmp_path):
    """The fit is cached under a key of the scene, steps, config and init;
    a later call loads it (no step); a truncated file is deleted, the model
    fitted again and the file replaced by one that loads."""
    monkeypatch.setenv("HCUNET_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("HCUNET_NO_CACHE", raising=False)
    steps = []
    step = UNetTrainer.train_step
    monkeypatch.setattr(UNetTrainer, "train_step",
                        lambda self, *a: steps.append(1) or step(self, *a))
    cfg = UNetConfig(**SMALL)
    vol, truth = bench._blob_scene(40, 40, 6, n_cells=2)

    def fit():
        return bench._fit_unet_to_scene(bench._init_unet(cfg, torch.float32), vol, truth,
                                        steps=1, device="cpu").state_dict()

    first = fit()
    (path,) = [tmp_path / n for n in os.listdir(tmp_path)]
    assert path.name.startswith("bench_fit_") and len(steps) == 1
    again = fit()
    assert len(steps) == 1 and all(torch.equal(first[k], again[k]) for k in first)
    path.write_bytes(path.read_bytes()[: path.stat().st_size // 2])
    refit = fit()
    assert len(steps) == 2
    loaded = torch.load(path, weights_only=True)
    assert all(torch.equal(loaded[k], refit[k]) for k in refit)
    assert os.listdir(tmp_path) == [path.name]


# --- parity with the JAX twin ---------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3])
def test_blob_scene_is_the_twins(seed):
    got = bench._blob_scene(96, 96, 6, n_cells=5, seed=seed)
    want = jbench._blob_scene(96, 96, 6, n_cells=5, seed=seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_fit_matches_the_twin(monkeypatch):
    """3 steps of the port's fit against the JAX bench's bare optax loop
    from the same weights on the same scene, float32, no cache."""
    monkeypatch.setenv("HCUNET_NO_CACHE", "1")
    cfg, jmodel, variables = jax_unet(SMALL, (40, 40, 6))
    vol, truth = bench._blob_scene(40, 40, 6, n_cells=3, seed=1)
    want = jbench._fit_unet_to_scene(jmodel, variables, vol, truth, steps=3)
    model = bench._fit_unet_to_scene(port_unet(cfg, variables), vol, truth, steps=3,
                                     device="cpu")
    got = jax_variables_from_unet_state_dict(model.state_dict(), cfg)
    assert_trajectories_match(got, jax.tree.map(np.asarray, want), variables, bench.FIT_LR, 3)


def test_headline_sum_matches_the_twin():
    """The headline's synced scalar, the probability map's sum, against the
    JAX ``predict_segmentation_mask(...).sum()`` on the same float32 volume
    and weights: within 1e-5 a voxel."""
    cfg, jmodel, variables = jax_unet(SMALL, (48, 56, 12))
    tile = dict(eval_size=(16, 24, 8), pad=(16, 16, 2), batch=4)
    vol = np.random.default_rng(2).random((1, 40, 50, 9, 4), dtype=np.float32)
    japply = jax.tree_util.Partial(lambda v, t: jmodel.apply(v, t, train=False), variables)
    want = float(jax_predict_segmentation_mask(japply, jnp.asarray(vol), jmodel.config,
                                               JaxTileConfig(**tile),
                                               use_probability_map=True).sum())
    tapply = compile_serving_apply(port_unet(cfg, variables), dtype=torch.float32, device="cpu")
    got = bench._headline_sum(tapply, torch.from_numpy(vol), cfg, TileConfig(**tile), "cpu")
    assert abs(got - want) <= 1e-5 * vol[..., 0].size, (got, want)


# the twin's record keys, and the port's one addition
TWIN_KEYS = {"metric", "value", "unit", "vs_baseline", "reps"}
PIPELINE_KEYS = TWIN_KEYS | {"stage_seconds", "transfer_mb"}


@pytest.mark.parametrize("metric", METRICS)
def test_metric_record_at_a_tiny_size(monkeypatch, metric):
    """Each metric's record, run at a tiny size on the CPU (the card's
    code path, minus the kernels): the twin's keys plus ``device``, which
    names the CPU."""
    monkeypatch.setenv("HCUNET_NO_CACHE", "1")
    cfg = UNetConfig(**SMALL)
    if metric == "tiled_unet3d_inference":
        rec, keys = bench.headline_metric("cpu", (40, 48, 8), cfg), TWIN_KEYS
    elif metric == "recurrent_packed_serving":
        rec, keys = bench.recurrent_metric(
            "cpu", (32, 32, 4), RUNetConfig(channels=(4, 8, 16), timesteps=2)), TWIN_KEYS
    else:
        det = Detector(DetectorConfig(rpn_pre_nms_top_n=32, rpn_post_nms_top_n=8,
                                      max_detections=4),
                       backbone="small", dtype=torch.bfloat16, device="cpu")
        rec = bench.pipeline_metric("cpu", bench._blob_scene(96, 96, 6, n_cells=5), cfg,
                                    detector=det)
        keys = PIPELINE_KEYS
        assert set(rec["stage_seconds"]) == {"detect", "unet", "instance", "analytics"}
    assert set(rec) == keys | {"device"}
    assert rec["metric"] == metric and rec["unit"] == "MVx/s" and rec["reps"] == 3
    assert np.isfinite(rec["value"]) and rec["value"] > 0
    assert rec["device"] == {"name": "cpu", "power_limit": None}
