"""The control of a cell's check: the plain reference, put in the program's
place and computed one precision below what the cell's mix states (TF32
for float32, float8 e4m3 for bfloat16), compared with the float32
reference by the same numbers as a run's check.  It has to read above the
limits, as a run of the program has to read below them.  The benchmark's
runs do not run it: ``portbench/readings.py`` reads it beside the
program's numbers, and the CPU tests hold it at a small size.
"""

from __future__ import annotations

from portbench import bench

LOWER = {"float32": "tf32", "bfloat16": "fp8"}


def control_numbers(workload: str, seed: int, device="cuda", overrides=None) -> dict:
    """The control's numbers on the inputs of a run of ``seed``."""
    cell = bench.resolve(bench.load_spec(), workload, overrides)
    run = bench.Run(cell, seed, device)
    return run.entry.control(run, LOWER[run.dtype_name])
