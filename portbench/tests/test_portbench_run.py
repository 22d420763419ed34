"""Whole runs of the harness: on the CPU at small sizes through
:func:`portbench.bench.run_cell`, the command's refusals, no JAX loaded,
the program broken underneath so that ``correct`` comes out false, the
controls failing the checks, and (on the card) the command itself."""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import bench
from portbench.control import control_numbers
from portbench.tests.conftest import ROOT, SMALL

CELLS = list(SMALL)
SEED = 2**31 + 77


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_a_small_run_is_correct(workload, trace):
    result = bench.run_cell(workload, SEED, 0.3, trace, device="cpu",
                            overrides=SMALL[workload])
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    cell = bench.resolve(bench.load_spec(), workload)
    if trace:
        assert "breakdown" in result and result["device"]["window_s"] > 0
        assert any(name.startswith("mfu_pct.") for name in result["metrics"])
    else:
        assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
        assert all(math.isfinite(m["value"]) and m["value"] > 0
                   for m in result["metrics"].values())


def _program_fault(monkeypatch, workload):
    """Break the program underneath the entry a cell drives: its answer
    altered where it is produced (the logits of the first tile of each
    U-Net batch moved by 1, a patch of 16 x 16 columns of the recurrent
    head by 1: its check is the head's root-mean-square gap).  No cell
    trains, and none runs on more than one chip or at a batch over 1."""
    if workload == "runet-bf16-b1-256":
        from hcunet_tpu_torch.infer import compile_recurrent as module

        name = "compile_recurrent_apply"
    else:
        from hcunet_tpu_torch.infer import compile as module

        name = "compile_serving_apply"
    build = getattr(module, name)

    def broken(*args, **kwargs):
        apply_fn = build(*args, **kwargs)

        def altered(x):
            out = apply_fn(x).clone()
            if name == "compile_serving_apply":
                out[0] += 1.0
            else:
                out[:, :16, :16] += 1.0
            return out

        altered.device = getattr(apply_fn, "device", None)
        return altered

    monkeypatch.setattr(module, name, broken)


@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_program_is_not_correct(workload, monkeypatch):
    _program_fault(monkeypatch, workload)
    result = bench.run_cell(workload, SEED, 0.3, False, device="cpu",
                            overrides=dict(SMALL[workload],
                                           mix={**SMALL[workload]["mix"], "sample": 4}))
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_the_checks(workload):
    """The reference one precision below the cell's (TF32 for float32,
    float8 for bfloat16) in the program's place reads above a limit."""
    limits = bench.resolve(bench.load_spec(), workload).mix["checks"]
    numbers = control_numbers(workload, SEED, "cpu", SMALL[workload])
    assert any(numbers[k] > limits[k] for k in limits), (numbers, limits)


def test_the_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           "runet-bf16-b1-256", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_no_jax_after_a_run():
    """A fresh interpreter that imports the harness and runs a cell holds no
    module of JAX or of the JAX package, by whole top-level name."""
    code = (
        "import sys, json\n"
        "from portbench import bench\n"
        "from portbench.tests.conftest import SMALL\n"
        "from portbench.run import banned_modules\n"
        "for w in SMALL:\n"
        "    assert bench.run_cell(w, 5, 0.1, True, device='cpu', overrides=SMALL[w])['correct']\n"
        "print(json.dumps(banned_modules()))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    banned, loaded = (json.loads(line) for line in proc.stdout.strip().splitlines()[-2:])
    assert banned == [] and "hcunet_tpu_torch" in loaded
    assert not {"jax", "jaxlib", "flax", "optax", "hcunet_tpu"} & set(loaded)


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "portbench/reference").glob("*.py"):
        text = path.read_text()
        assert "import hcunet" not in text and "from hcunet" not in text, path


def test_a_directory_without_the_program_gives_no_result(tmp_path):
    """With only BENCHMARK.json and the benchmark's files, a run fails and
    prints no result line."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, '.')\n"
            "from portbench import bench\n"
            "print(bench.run_cell('runet-bf16-b1-256', 1, 0.1, False, device='cpu'))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "hcunet_tpu_torch" in proc.stderr


def test_the_command_on_the_card(cuda_device):
    """One short run of the smallest cell through the command."""
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           "runet-bf16-b1-256", "--seed", str(SEED), "--seconds", "2",
                           "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
