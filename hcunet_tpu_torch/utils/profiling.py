"""Profiling and numerical-hygiene hooks (twin of
``hcunet_tpu/utils/profiling.py``).

* :func:`trace`: a ``torch.profiler`` trace over the host and, where there
  is one, the CUDA device, written as a Chrome trace (open it in
  ``chrome://tracing`` or Perfetto);
* :func:`span`: a named range of the serving paths in that trace, on the
  profiler's clock, and nothing while no profiler collects;
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


# what span() hands out while no profiler collects: one shared, reentrant
# context that enters no RecordFunction
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """``with span("hcunet.serve.predict"): ...``: a named range of the
    program in the profiler's trace.

    While a profiler collects (``torch.profiler`` or
    ``torch.autograd.profiler``, in any thread), a
    ``torch.profiler.record_function`` range, on the profiler's clock beside
    the device's kernels and copies; else one shared no-op context, at the
    cost of reading one flag (an idle ``record_function`` costs some 14 us
    a call on a CPU, the flag some 0.1 us).  A span adds no device
    synchronisation and reads nothing back from the device.  ``name`` is a
    fixed string under ``hcunet.``, so that the calls of one span sum.

    Spans carry no request id: a request's spans are the ones contained in
    its outermost span on the thread that made the call.  This holds while
    one client drives the program from one thread; the ``analyze``
    pipeline's tail workers run on their own threads, and their spans
    carry those threads' ids."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block with ``torch.profiler`` (host activity on every
    thread, the ``analyze`` pipeline's tail workers too, and CUDA activity
    when CUDA is available) and write the Chrome trace
    ``trace_<pid>_<time>.json`` into ``log_dir``.  The program's
    :func:`span` ranges are in it."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    every_thread = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with torch.profiler.profile(activities=activities, experimental_config=every_thread) as prof:
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
