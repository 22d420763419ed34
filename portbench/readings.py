"""The readings a cell's limits are set from: the program's numbers over
many seeds and the control's over a few, read in one process (the
card's start and the imports paid once).

    python3 portbench/readings.py --workload <name> --seeds 1,2,... \\
        --control-seeds 101,102,103 [--seconds 3]

Each program run is a whole run of the cell (its set-up, a window of
``--seconds``, its check); each control reading is
:func:`portbench.control.control_numbers`.  Prints one JSON line a
reading, then the largest program reading and the smallest control
reading of each number beside the cell's limits, and whether the control
reads above one of them.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from portbench import bench  # noqa: E402
from portbench.control import control_numbers  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--seconds", type=float, default=3.0)
    args = parser.parse_args(argv)
    spec = bench.load_spec()
    high, low = {}, {}
    for seed in (int(s) for s in args.seeds.split(",") if s):
        result = bench.run_cell(args.workload, seed, args.seconds, False, spec=spec)
        numbers = result["numbers"]
        print(json.dumps({"seed": seed, "program": numbers, "correct": result["correct"],
                          "metrics": result["metrics"]}), flush=True)
        for k, v in numbers.items():
            high[k] = max(high.get(k, v), v)
        torch.cuda.empty_cache()
    for seed in (int(s) for s in args.control_seeds.split(",") if s):
        numbers = control_numbers(args.workload, seed)
        print(json.dumps({"seed": seed, "control": numbers}), flush=True)
        for k, v in numbers.items():
            low[k] = min(low.get(k, v), v)
        torch.cuda.empty_cache()
    limits = bench.resolve(spec, args.workload).mix["checks"]
    print(json.dumps({"workload": args.workload, "program_highest": high,
                      "control_lowest": low, "limits": limits,
                      "control_fails": any(low[k] > limits[k] for k in limits if k in low)}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
