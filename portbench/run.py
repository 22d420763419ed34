"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, its traffic mix,
its entry, its plain reference and its per-layer metrics are found by name
from ``BENCHMARK.json`` (:mod:`portbench.bench`).  With ``--trace 0`` the
line holds the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics from a profiled window.  The line's ``checks`` are the numbers
compared with the reference, each with its limit; they are also the last
lines on standard error.  Without as many CUDA cards as the cell asks for,
or with JAX or the JAX package loaded once the window has closed, the run
prints no result and exits 1.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the kernel caches stay inside the checkout, at fixed paths, so that only
# a checkout's first run builds: K1's libraries go to build/ (the port's
# csrc/__init__.py), anything Triton or torch's extension loader builds
# goes beside them
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
# one process with few threads: the host side of a run is one Python thread
# launching work and copying, so the CPU's thread pools only add jitter
os.environ["OMP_NUM_THREADS"] = "1"
os.environ["MKL_NUM_THREADS"] = "1"
sys.path.insert(0, str(ROOT))

# compared by whole top-level module names: the port's name begins with the
# JAX package's
BANNED = ("jax", "jaxlib", "flax", "optax", "hcunet_tpu")


def banned_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(BANNED))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from portbench import bench

    torch.set_num_threads(1)

    spec = bench.load_spec()
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 1
    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    result = bench.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                            device="cuda", t_start=T_START, spec=spec)
    found = banned_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {', '.join(found)}",
              file=sys.stderr)
        return 1
    bench.print_checks(result)
    result.pop("numbers")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
