"""One run of one cell: set-up, the measured window, the check of what the
window produced against the plain reference, and the result line.

Everything a cell is made of is found by name from ``BENCHMARK.json``:

* its configuration: ``portbench/configs/<config>.json``;
* its traffic mix: ``portbench/traffic/<mix>.json``, read by
  :mod:`portbench.generator`; the mix names the entry its requests go to,
  ``portbench/entries/<entry>.py``, and the limits of its checks;
* the plain reference of its configuration: ``portbench/reference/<config>.py``;
* each per-layer metric: ``portbench/metrics/<metric>.py``, whose
  ``read(obs)`` returns the number or None.

An entry module gives ``setup(run)`` (the program built, its inputs made,
every shape warmed), ``request(state, item)`` (one request through the
program, returning once its answer is on the host), ``release(state)``
(the program's state freed), ``check(run, state)`` (the numbers compared,
against the reference) and ``k1_launches(run, item)`` (the K1 launches the
request should make, from :mod:`portbench.flops`).
"""

from __future__ import annotations

import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import generator, trace as tracing
from portbench.inputs import make_weights, sub_seed

ROOT = Path(__file__).resolve().parents[1]
BENCH_DIR = ROOT / "portbench"
SPEC_PATH = ROOT / "BENCHMARK.json"


# --- finding a cell's files by name ------------------------------------------


def load_spec(path: Path = SPEC_PATH) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """The Python file at ``path`` as a module (names may hold ``-`` and
    ``.``, so files are loaded by path, not imported by name)."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path.relative_to(ROOT)}")
    name = "portbench_file_" + "".join(c if c.isalnum() else "_" for c in path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def traffic_path(name: str) -> Path:
    return BENCH_DIR / "traffic" / f"{name}.json"


def entry_path(name: str) -> Path:
    return BENCH_DIR / "entries" / f"{name}.py"


def reference_path(name: str) -> Path:
    return BENCH_DIR / "reference" / f"{name}.py"


def metric_path(name: str) -> Path:
    return BENCH_DIR / "metrics" / f"{name}.py"


def resolve(spec: dict, workload: str, overrides: Optional[dict] = None) -> SimpleNamespace:
    """A cell's entry in ``spec`` and every file it names, read;
    ``overrides`` (``{"config": {...}, "mix": {...}}``) replaces keys of the
    configuration and the mix (the CPU tests run cells at small sizes)."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    with open(BENCH_DIR.parent / configs[cell["config"]]["file"]) as f:
        config = json.load(f)
    with open(traffic_path(cell["traffic"])) as f:
        mix = json.load(f)
    config.update((overrides or {}).get("config", {}))
    mix.update((overrides or {}).get("mix", {}))
    return SimpleNamespace(
        cell=cell, config=config, mix=mix,
        entry=entry_path(mix["entry"]), reference=reference_path(cell["config"]),
        end_to_end=[m for m in spec["end_to_end"]
                    if workload in m.get("workloads", [workload])],
        per_layer=[m for m in spec["per_layer"]
                   if workload in m.get("workloads", [workload])],
    )


# --- the run -------------------------------------------------------------------


class Run:
    """What one run knows: the cell's configuration and mix, the seed, the
    device, the requests of its pool, and the weights the benchmark made
    (its own copy, handed to the program and, after the window, to the
    reference)."""

    def __init__(self, cell: SimpleNamespace, seed: int, device):
        self.seed = int(seed)
        self.config, self.mix = cell.config, cell.mix
        self.device = torch.device(device)
        self.dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[self.mix["dtype"]]
        self.dtype_name = self.mix["dtype"]
        self.entry = load_module(cell.entry)
        self.reference = load_module(cell.reference)
        self.requests = generator.pool(self.mix, self.seed)
        self.weights = make_weights(self.reference.param_specs(self.config),
                                    sub_seed(self.seed, "weights"), self.device)
        self.kept: Dict[int, tuple] = {}
        self.sample_size = int(self.mix.get("sample", 1))
        self._rng = np.random.default_rng(sub_seed(self.seed, "sample"))
        self._seen = 0

    def keep(self, item, answer) -> None:
        """Keep a uniform sample of ``sample`` answers of the window
        (reservoir sampling, its draws from the run's seed) for the check."""
        n = self._seen
        self._seen += 1
        if n < self.sample_size:
            self.kept[n] = (item, answer)
        else:
            j = int(self._rng.integers(0, n + 1))
            if j < self.sample_size:
                self.kept[j] = (item, answer)

    def sampled(self) -> List[tuple]:
        return [self.kept[k] for k in sorted(self.kept)]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _window(run: Run, state, deadline_s: float, max_requests: Optional[int] = None):
    """Requests one after another until ``deadline_s`` has passed (or
    ``max_requests`` are done): returns each one's ``(item, seconds,
    ok)`` and the window's length, from its start to the end of the last
    request."""
    done = []
    k = 0
    t0 = time.perf_counter()
    while True:
        item = run.requests[k % len(run.requests)]
        k += 1
        t = time.perf_counter()
        with torch.profiler.record_function(tracing.REQUEST_SPAN):
            try:
                answer = run.entry.request(state, item)
                ok = True
            except Exception as exc:  # a failed request counts against the run
                print(f"request {k} failed: {type(exc).__name__}: {exc}", file=sys.stderr)
                answer, ok = None, False
        end = time.perf_counter()
        done.append((item, end - t, ok))
        if ok:
            run.keep(item, answer)
        if end - t0 >= deadline_s or (max_requests and len(done) >= max_requests):
            return done, end - t0


def _percentile(values: List[float], q: float) -> float:
    """The ``q``-th percentile of ``values`` by linear interpolation
    between order statistics (numpy's default)."""
    return float(np.percentile(np.asarray(values), q))


def _device_record(device: torch.device) -> dict:
    """The card's name and count as torch gives them, its power limit as
    ``nvidia-smi`` gives it (where it can), and the process's peak memory."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    index = device.index if device.index is not None else torch.cuda.current_device()
    limit = None
    try:
        line = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=30,
        ).stdout.strip()
        limit = line.rsplit(",", 1)[-1].strip() or None
    except (OSError, subprocess.SubprocessError):
        pass
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(index), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)),
            "power_limit": limit}


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, device="cuda",
             t_start: Optional[float] = None, spec: Optional[dict] = None,
             overrides: Optional[dict] = None) -> dict:
    """One run of ``workload``; returns the result line's object.
    ``overrides`` as :func:`resolve` takes them."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = resolve(spec or load_spec(), workload, overrides)
    run = Run(cell, seed, device)
    state = run.entry.setup(run)
    _sync(run.device)
    setup_s = time.perf_counter() - t_start

    counters0 = run.entry.counters(state)
    obs = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if run.device.type == "cuda" else [])
        with profile(activities=acts) as prof:
            with torch.profiler.record_function(tracing.WINDOW_SPAN):
                done, window_s = _window(run, state, seconds, int(run.mix["trace_requests"]))
        traced = tracing.export(prof)
        counters = {k: v - counters0[k] for k, v in run.entry.counters(state).items()}
        obs = SimpleNamespace(trace=traced, run=run, counters=counters,
                              requests=[d[0] for d in done])
    else:
        done, window_s = _window(run, state, seconds)
    device_rec = _device_record(run.device)

    run.entry.release(state)
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = run.entry.check(run, state)
    limits = run.mix["checks"]
    checks = {name: {"value": float(numbers[name]), "limit": float(limits[name])}
              for name in limits}
    failed = sum(1 for d in done if not d[2])
    correct = failed == 0 and bool(done) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())

    metrics: Dict[str, dict] = {}
    result = {"correct": correct, "attempted": len(done), "failed": failed}
    if trace:
        for m in cell.per_layer:
            value = load_module(metric_path(m["name"])).read(obs)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        device_rec["busy_s"] = obs.trace.busy_s()
        device_rec["window_s"] = obs.trace.window_s
        result["breakdown"] = {"device_ops": obs.trace.device_ops(),
                               "idle_gaps": obs.trace.idle_gaps()}
    else:
        ok = [d for d in done if d[2]]
        values = {
            "setup_s": setup_s,
            "mvx_per_s": sum(d[0].voxels for d in ok) / 1e6 / window_s,
            "request_p95_ms": _percentile([d[1] * 1e3 for d in ok], 95) if ok else math.nan,
        }
        # a metric split by the cells that report it (mvx_per_s.predict)
        # is worked out as its base
        for m in cell.end_to_end:
            value = values[m["name"].split(".")[0]]
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        lat = [d[1] * 1e3 for d in ok]
        if len(lat) > 1:
            print(f"window {window_s:.3f} s, {len(done)} requests, latency median "
                  f"{statistics.median(lat):.3f} ms, max {max(lat):.3f} ms", file=sys.stderr)
    # every number the check worked out, the compared ones and the rest
    # (the run's caller prints them apart from the result line)
    result.update({"metrics": metrics, "device": device_rec, "numbers": numbers,
                   "checks": checks})
    return result


def print_checks(result: dict) -> None:
    """The check's other numbers, then each number compared beside its
    limit, as the last lines of standard error."""
    others = {k: v for k, v in result["numbers"].items() if k not in result["checks"]}
    if others:
        print("not compared: " + ", ".join(f"{k} {v!r}" for k, v in others.items()),
              file=sys.stderr)
    for name, c in result["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr, flush=True)
