"""Read the numbers that set a cell's output limits, on the card.

    python -m benchmark.calibrate --workload <cell> --seeds 1,2,3 --control-seeds 4,5,6 [--seconds 2]

For each of ``--seeds`` the program runs the cell as ``benchmark.run`` does
(a window of ``--seconds``, then the output check) and the numbers it
compares are printed; for each of ``--control-seeds`` the control (the
reference one precision lower, in the program's place, at the cell's own
size) is compared the same way.  One JSON line each, then the largest of
each number over the program's seeds and the smallest over the control's.
The limit of a number lies between the two (``PERF.md`` gives the
readings and the limits); the benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys

from benchmark import common


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    lower, upper = {}, {}
    for kind, group in (("program", seeds), ("control", controls)):
        for seed in group:
            cell = common.load_cell(args.workload, seed, args.seconds, False)
            cell.device = torch.device("cuda", 0)
            driver = common.load_module("traffic", cell.traffic)
            if kind == "program":
                checks = driver.run(cell)["checks"]
                common.merge_worst(lower, checks)
            else:
                checks = driver.control(cell)
                for k, v in checks.items():
                    upper[k] = min(upper.get(k, float("inf")), v)
            print(json.dumps({"workload": cell.name, "kind": kind, "seed": seed,
                              "checks": checks}), flush=True)
            torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "program_max": lower,
                      "control_min": upper, "limits": cell.limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
