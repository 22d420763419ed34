"""The traced window: ``torch.profiler`` over it, and the reduction of its
trace to what the per-layer readers take.

The window is marked by the harness's own span ``portbench.window``; each
request inside it by ``portbench.request``.  Device activity is every
kernel, copy and memset event; the busy time is the union of their
intervals inside the window.  An idle gap is named by the innermost host
event (an operator or a span of the harness) running where it starts.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass
from typing import List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
WINDOW_SPAN = "portbench.window"
REQUEST_SPAN = "portbench.request"


@dataclass
class Trace:
    """Device events ``(cat, name, start_us, dur_us)``, host events, and the
    window ``(start_us, end_us)``."""

    device: List[Tuple[str, str, float, float]]
    host: List[Tuple[str, float, float]]
    window: Tuple[float, float]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def in_window(self, cats=DEVICE_CATS):
        t0, t1 = self.window
        for cat, name, s, d in self.device:
            if cat in cats and s < t1 and s + d > t0:
                yield cat, name, max(s, t0), min(s + d, t1)

    def busy_intervals(self, cats=DEVICE_CATS):
        """The union of the intervals of device events of ``cats`` inside
        the window, sorted."""
        return merge((s, e) for _c, _n, s, e in self.in_window(cats))

    def busy_s(self, cats=DEVICE_CATS) -> float:
        return union_s((s, e) for _c, _n, s, e in self.in_window(cats))

    def kernel_s(self, match: str) -> float:
        """Summed device time of the kernels whose name holds ``match``."""
        return sum(e - s for c, n, s, e in self.in_window(("kernel",)) if match in n) * 1e-6

    def kernel_count(self, match: str) -> int:
        return sum(1 for c, n, s, e in self.in_window(("kernel",)) if match in n)

    def device_ops(self, top: int = 10) -> List[List]:
        """The device operations that took most time, by name."""
        by = defaultdict(float)
        for _c, n, s, e in self.in_window():
            by[n[:120]] += (e - s) * 1e-6
        return [[n, t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """Idle time inside the window summed by what the host was doing
        where each gap starts, the largest first."""
        t0, t1 = self.window
        busy = self.busy_intervals()
        gaps, at = [], t0
        for s, e in busy:
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if at < t1:
            gaps.append((at, t1))
        # host events of the harness's thread nest: sweep them in start order
        # with a stack whose top is the innermost event still running
        host = sorted(self.host, key=lambda h: (h[1], -h[2]))
        by = defaultdict(float)
        stack, k = [], 0
        for gs, ge in gaps:
            while k < len(host) and host[k][1] <= gs:
                while stack and stack[-1][1] + stack[-1][2] < host[k][1]:
                    stack.pop()
                stack.append(host[k])
                k += 1
            while stack and stack[-1][1] + stack[-1][2] < gs:
                stack.pop()
            by[stack[-1][0] if stack else "no host event"] += (ge - gs) * 1e-6
        return [[n, t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def merge(spans) -> List[List[float]]:
    """The union of intervals ``(start, end)``, as sorted disjoint ones."""
    merged: List[List[float]] = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def union_s(spans) -> float:
    """Seconds covered by intervals given in microseconds."""
    return sum(e - s for s, e in merge(spans)) * 1e-6


def parse(path: str) -> Trace:
    """Read a chrome trace written by ``torch.profiler``'s
    ``export_chrome_trace``."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device, host, window = [], [], None
    spans = [ev for ev in events if ev.get("name") == WINDOW_SPAN]
    main_tid = spans[0].get("tid") if spans else None
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        s, d = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append((cat, name, s, d))
        elif cat in HOST_CATS:
            if name == WINDOW_SPAN:
                window = (s, s + d)
            if ev.get("tid") == main_tid:
                host.append((name, s, d))
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW_SPAN} span")
    return Trace(device, host, window)


def export(prof) -> Trace:
    """The profiler's trace, through a file in the run's ``TMPDIR`` that is
    removed once read."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return parse(path)
    finally:
        os.remove(path)
