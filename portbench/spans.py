"""The device's idle time credited to the program's spans.

The port opens ``torch.profiler.record_function`` ranges at the layer
boundaries of its serving paths (``hcunet_tpu_torch/utils/profiling.py::
span``): ``hcunet.serve.predict`` and, inside it, ``hcunet.serve.bucket_pad``,
``hcunet.tiling.upload``, ``hcunet.tiling.tiles`` and ``hcunet.serve.readback``;
``hcunet.recurrent.forward`` and, inside it, ``hcunet.recurrent.upload`` and
one ``hcunet.recurrent.timestep`` a timestep.  They share the profiler's clock
with the device's events.

The device is idle where no kernel, copy or memset runs inside the window
(as ``device_idle_pct.*`` reads it).  A span's instances are the host events
of its name on the harness's thread, merged into one union so that nested
instances count once.  The idle time inside a span is the overlap of the
idle intervals with that union: each stretch of idle time goes to every span
the host was inside, where :meth:`portbench.trace.Trace.idle_gaps` names a
gap only by the host event running where it starts.  Every reduction
returns None where the window holds no instance of its span (a program
without the spans reads nothing, not zero).
"""

from __future__ import annotations

from typing import List, Optional

from portbench import trace as tracing


def idle_intervals(trace) -> Optional[List[List[float]]]:
    """The window less the union of the device's kernels, copies and
    memsets: sorted disjoint ``[start_us, end_us]``; None where the trace
    holds no device event (a run without a card)."""
    if not trace.device:
        return None
    t0, t1 = trace.window
    gaps, at = [], t0
    for s, e in trace.busy_intervals():
        if s > at:
            gaps.append([at, s])
        at = max(at, e)
    if at < t1:
        gaps.append([at, t1])
    return gaps


def span_union(trace, name: str) -> List[List[float]]:
    """The union of the instances of span ``name`` on the harness's thread,
    clipped to the window."""
    t0, t1 = trace.window
    return tracing.merge((max(s, t0), min(s + d, t1)) for n, s, d in trace.host
                         if n == name and s < t1 and s + d > t0)


def overlap_us(a: List[List[float]], b: List[List[float]]) -> float:
    """Microseconds covered by both of two sorted disjoint interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_inside_us(trace, name: str) -> Optional[float]:
    """Microseconds of device idle time inside span ``name``; None without
    an instance of it in the window."""
    spans, idle = span_union(trace, name), idle_intervals(trace)
    if not spans or idle is None:
        return None
    return overlap_us(idle, spans)


def idle_ms_per_request(obs, name: str) -> Optional[float]:
    """Device idle time inside span ``name``, in ms a request the window
    served."""
    idle = idle_inside_us(obs.trace, name)
    if idle is None or not obs.requests:
        return None
    return idle * 1e-3 / len(obs.requests)


def idle_share_of_span_pct(obs, name: str) -> Optional[float]:
    """Device idle time inside span ``name`` over the length of its union,
    in %: the share of the span in which the card waited on the host."""
    length = sum(e - s for s, e in span_union(obs.trace, name))
    idle = idle_inside_us(obs.trace, name)
    if idle is None or length <= 0:
        return None
    return 100.0 * idle / length


def idle_in_program_pct(obs, name: str) -> Optional[float]:
    """Device idle time inside span ``name`` over all the window's idle
    time, in %: the share of the idle time the program, not the harness
    around it, was running on the host."""
    inside = idle_inside_us(obs.trace, name)
    if inside is None:
        return None
    total = sum(e - s for s, e in idle_intervals(obs.trace))
    return 100.0 * inside / total if total > 0 else None
