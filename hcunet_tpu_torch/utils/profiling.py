"""Profiling and numerical-hygiene hooks (twin of
``hcunet_tpu/utils/profiling.py``).

* :func:`trace`: a ``torch.profiler`` trace over the host and, where there
  is one, the CUDA device, written as a Chrome trace (open it in
  ``chrome://tracing`` or Perfetto);
* :func:`timed`: host wall-clock stage timing with a device sync;
* :func:`enable_nan_checks`: autograd's anomaly mode;
* :func:`assert_finite`: a finite check over a nested structure that names
  the bad leaf.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Iterator, List, Tuple

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block with ``torch.profiler`` (host activity, and CUDA
    activity when CUDA is available) and write the Chrome trace
    ``trace_<pid>_<time>.json`` into ``log_dir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.strftime('%Y%m%d_%H%M%S')}.json")
    )


def _leaves(tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` of every leaf of nested dicts, lists and tuples,
    the path's keys joined by ``/``."""
    if isinstance(tree, dict):
        return [leaf for k, v in tree.items() for leaf in _leaves(v, f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [leaf for i, v in enumerate(tree) for leaf in _leaves(v, f"{path}/{i}")]
    return [(path, tree)]


def device_sync(x: Any) -> None:
    """Wait for all work queued on the device of every CUDA tensor among
    the leaves of ``x`` (``torch.cuda.synchronize`` per device; CUDA
    returns from it only when the device is done)."""
    devices = {
        leaf.device for _p, leaf in _leaves(x)
        if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda"
    }
    for dev in devices:
        torch.cuda.synchronize(dev)


class timed:
    """``with timed("stage") as t: ...`` then ``t.seconds``; ``sync``: a
    structure whose CUDA tensors are waited for before the clock stops."""

    def __init__(self, label: str = "", sync: Any = None):
        self.label = label
        self.sync = sync
        self.seconds = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync is not None:
            device_sync(self.sync)
        self.seconds = time.perf_counter() - self._t0
        return False


def enable_nan_checks(on: bool = True) -> None:
    """Turn autograd's anomaly mode on or off
    (``torch.autograd.set_detect_anomaly``).

    Not the JAX package's ``jax_debug_nans``: that trap raises at the first
    operation anywhere that produces a NaN.  PyTorch has no such global
    trap; anomaly mode raises when a backward function returns a NaN and
    names the forward operation that created it, and checks no forward
    pass.  Use :func:`assert_finite` on forward outputs."""
    torch.autograd.set_detect_anomaly(on)


def assert_finite(tree: Any, name: str = "tree") -> None:
    """Raise ``FloatingPointError`` naming the first leaf of ``tree`` (nested
    dicts, lists, tuples of tensors or arrays) that holds a NaN or an
    infinity."""
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            ok = bool(torch.isfinite(leaf).all())
        else:
            ok = bool(np.isfinite(np.asarray(leaf)).all())
        if not ok:
            raise FloatingPointError(f"non-finite values in {name}{path}")
