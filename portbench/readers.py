"""What the per-layer readers share: the reductions of a traced window.

Each reader in ``portbench/metrics/`` takes the observation of a traced
run (``obs.trace``, the parsed trace; ``obs.run``, the run; ``obs.requests``,
the requests the window served; ``obs.counters``, the program's counters'
growth over the window) and returns its number, or None where it finds
nothing to read.
"""

from __future__ import annotations

import sys
from typing import Optional

from portbench import flops, trace as tracing

# K1's kernels: every kernel compiled from csrc/conv3d_valid.cu has this in its name
K1_KERNEL = "conv3d_valid"


def idle_pct(obs) -> Optional[float]:
    """The share of the window in which no kernel, copy or memset ran."""
    if obs.trace.window_s <= 0 or not obs.trace.device:
        return None
    return 100.0 * (1.0 - obs.trace.busy_s() / obs.trace.window_s)


def k1_roofline_pct(obs) -> Optional[float]:
    """K1's least time over its device time: the least time summed over the
    launches the served requests should make (:mod:`portbench.flops`),
    the device time summed over the profiler's K1 kernels.  The launches
    counted by the program and those in the trace are printed beside the
    expected count; where either differs, the list is stale and the reader
    returns None."""
    run = obs.run
    expected = [launch for item in obs.requests for launch in run.entry.k1_launches(run, item)]
    counted = sum(v for k, v in obs.counters.items() if k.startswith("k1"))
    traced = obs.trace.kernel_count(K1_KERNEL)
    print(f"K1 launches over {len(obs.requests)} requests: program {counted}, trace {traced}, "
          f"layer list {len(expected)}", file=sys.stderr)
    seconds = obs.trace.kernel_s(K1_KERNEL)
    if not expected or counted != len(expected) or traced != len(expected) or seconds <= 0:
        return None
    least = sum(launch.least_seconds(run.dtype_name) for launch in expected)
    return 100.0 * least / seconds


def mfu_pct(obs) -> Optional[float]:
    """The model's FLOPs for the served requests (one forward each) over
    the window's length times the peak of the dtype the program computes
    in."""
    run = obs.run
    if obs.trace.window_s <= 0 or not obs.requests:
        return None
    work = sum(flops.model_flops(run.config, item.voxels) for item in obs.requests)
    return 100.0 * work / (obs.trace.window_s * flops.PEAK_FLOPS[run.dtype_name])


def copy_share_pct(obs) -> Optional[float]:
    """The share of the window in which the card copied between host and
    device: the union of the profiler's host-to-device and device-to-host
    copies."""
    t = obs.trace
    copies = [(s, e) for _c, n, s, e in t.in_window(("gpu_memcpy",)) if "HtoD" in n or "DtoH" in n]
    if not copies or t.window_s <= 0:
        return None
    return 100.0 * tracing.union_s(copies) / t.window_s
