"""BENCHMARK.json against the benchmark's contract, every name resolving to
its files, and a cell added by adding files alone."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from portbench import bench
from portbench.tests.conftest import ROOT, SMALL

SPEC = bench.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_spec_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert len(json.dumps(SPEC)) <= 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    names = [c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]]
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    for name in names + metrics:
        assert NAME.match(name), name
    assert len(set(metrics)) == len(metrics)
    assert len({w["name"] for w in SPEC["workloads"]}) == len(SPEC["workloads"])
    for text in ([c["why"] for c in SPEC["configs"] + SPEC["workloads"]]
                 + [c["source"] for c in SPEC["configs"]]
                 + [m["layer"] for m in SPEC["per_layer"]] + SPEC["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text, text


def test_metrics_follow_the_contract():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["moves"] in e2e
        # each cell the metric lists reports the end-to-end metric it moves
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    for w in SPEC["workloads"]:
        reported = [m for m in SPEC["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert len(reported) >= 2 and any(m["name"] == "setup_s" for m in reported)
        assert any(w["name"] in m["workloads"] for m in SPEC["per_layer"])
        assert w["chips"] == 1


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_resolves_to_its_files(workload):
    cell = bench.resolve(SPEC, workload)
    assert cell.entry.is_file() and cell.reference.is_file()
    for name in ("setup", "request", "release", "check", "control", "counters", "k1_launches"):
        assert callable(getattr(bench.load_module(cell.entry), name))
    for m in cell.per_layer:
        assert callable(bench.load_module(bench.metric_path(m["name"])).read)
    configs = {c["name"]: c for c in SPEC["configs"]}
    assert (ROOT / configs[cell.cell["config"]]["file"]).is_file()
    assert set(cell.mix["checks"]) and cell.mix["dtype"] in ("float32", "bfloat16")


def test_paths_hold_the_benchmark_alone():
    assert SPEC["paths"] == ["portbench"]
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    for c in SPEC["configs"]:
        assert c["file"].startswith("portbench/configs/")


def test_a_cell_is_added_by_adding_files(tmp_path, monkeypatch):
    """A throwaway cell: a new traffic mix and a new per-layer metric, each
    a new file, and new entries in a copy of BENCHMARK.json; no file of the
    benchmark is edited, and the cell runs and reports the metric."""
    copy = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", copy, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(copy): p.read_bytes() for p in copy.rglob("*") if p.is_file()}
    mix = json.loads((copy / "traffic" / "chunk2304-f32.json").read_text())
    mix.update({"shape": [20, 20, 5], "pool": 1, "trace_requests": 1})
    (copy / "traffic" / "chunk20-f32.json").write_text(json.dumps(mix))
    (copy / "metrics" / "requests_traced.any.py").write_text(
        "def read(obs):\n    return float(len(obs.requests))\n")
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "unet3d-f32-chunk20", "config": "unet3d-production",
                              "traffic": "chunk20-f32", "chips": 1, "why": "a throwaway cell"})
    spec["per_layer"].append({"name": "requests_traced.any", "unit": "requests",
                              "better": "higher", "source": "program_counter", "layer": "device",
                              "moves": "setup_s", "workloads": ["unet3d-f32-chunk20"]})
    monkeypatch.setattr(bench, "BENCH_DIR", copy)
    result = bench.run_cell("unet3d-f32-chunk20", 7, 0.1, True, device="cpu", spec=spec,
                            overrides={"config": SMALL["unet3d-f32-chunk2304"]["config"]})
    assert result["correct"]
    assert result["metrics"]["requests_traced.any"]["value"] == 1.0
    after = {p.relative_to(copy): p.read_bytes() for p in copy.rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items() if "__pycache__" not in k.parts)
