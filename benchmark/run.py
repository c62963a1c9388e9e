"""Run one cell of the port's benchmark once and print its result line.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, its traffic driver and its per-layer metrics
are found by name from ``BENCHMARK.json`` (see ``benchmark/common.py``).
The run needs the CUDA cards the cell asks for and exits with a non-zero
code, printing no result, without them: it never falls back to the CPU.

With ``--trace 0`` the result's metrics are the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics, read from a short profiled
sub-window that follows the timed window.  Either way the driver's output
check decides ``correct``: each number compared is printed beside its
limit as the last lines on standard error and under ``checks``, the result
line's last key.  The result line is the last line on standard output.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys

from benchmark import common


@dataclasses.dataclass
class Reading:
    """What a per-layer reader reads: the run's trace (or None), the pairs
    it covered, the run's host-clock numbers and the program's counters."""

    cell: common.Cell
    trace: object
    traced_pairs: int
    host: dict
    counters: dict


def metrics_of(spec: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer ones."""
    e2e = [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if cell in m["workloads"] or ("workloads" not in m and m["moves"] in names)]


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


def main(argv=None) -> int:
    started = common.process_start()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = common.benchmark_spec()
    entry = next((w for w in spec["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"benchmark: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    cell = common.load_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    chips = entry["chips"]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {cell.name} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    # every build and kernel cache at a fixed path inside the checkout
    cache = common.ROOT / "build" / "benchmark"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    cell.device = torch.device("cuda", 0)
    torch.set_num_threads(1)  # one process, few threads: steadier host-bound cells

    out = common.load_module("traffic", cell.traffic).run(cell)

    values = {"setup_s": out["setup_end"] - started, **out["metrics"]}
    reading = Reading(cell, out["trace"], out["traced_pairs"], out.get("host", {}),
                      out.get("counters", {}))
    metrics = {}
    for m in metrics_of(spec, cell.name, cell.trace):
        v = (common.load_module("layer_metrics", m["name"]).read(reading) if cell.trace
             else values[m["name"]])
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(cell.device),
              "count": chips, "memory_peak_bytes": int(out["memory_peak_bytes"])}
    card = power_limit()
    if card:
        device["card"] = card
    result = {"correct": None, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device}
    if out["trace"] is not None:
        device["busy_s"] = out["trace"].busy_s
        device["window_s"] = out["trace"].window_s
        result["breakdown"] = out["trace"].breakdown()
    checks = {k: {"value": v, "limit": cell.limits.get(k)} for k, v in out["checks"].items()}
    result["correct"] = common.judge(out["checks"], cell.limits)
    for c in checks.values():  # JSON has no inf or NaN
        c["value"] = c["value"] if math.isfinite(c["value"]) else repr(c["value"])
    result["checks"] = checks

    foreign = common.foreign_modules()
    if foreign:
        print(f"benchmark: the run loaded {', '.join(foreign)}; no result", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    for k, c in checks.items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
