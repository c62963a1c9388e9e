"""What every part of the benchmark shares: the cell, found by name in
``BENCHMARK.json`` and the files it names, and the small helpers around it.

A cell is ``benchmark/workloads/<cell>.json`` (its configuration's name,
its traffic driver's name, the traffic's parameters, the limits of its
output check) and ``benchmark/configs/<config>.json`` (the pipeline's
fields).  A traffic driver is ``benchmark/traffic/<traffic>.py`` and a
per-layer metric's reader ``benchmark/layer_metrics/<metric>.py``; both are
loaded from their files by name, so adding one is adding files.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
# the reference package and the modules the port must not load in a run,
# compared by top-level name (the part before the first dot), whole
FOREIGN = ("jax", "jaxlib", "flax", "nsof_tpu")
GIB = float(1 << 30)


@dataclasses.dataclass
class Cell:
    """One run of one cell."""

    name: str
    config: dict  # benchmark/configs/<config>.json
    traffic: str
    params: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: object = None  # torch.device
    scratch: pathlib.Path = ROOT / "build" / "benchmark"

    def pipeline_config(self):
        """The port's ``PipelineConfig`` of the configuration file."""
        from nsof_tpu_torch.config import config_from_dict

        keys = ("name", "image_h", "image_w", "roi", "fb", "head", "window_h", "window_w",
                "sep_window_h", "sep_window_w", "merge_flag", "offset", "warp_radius")
        return config_from_dict({k: self.config[k] for k in keys if k in self.config})


def read_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec(root: pathlib.Path = ROOT) -> dict:
    return read_json(root / "BENCHMARK.json")


def load_cell(name: str, seed: int, seconds: float, trace: bool,
              root: pathlib.Path = ROOT) -> Cell:
    """The cell ``name`` from its file and its configuration's file."""
    wl = read_json(root / "benchmark" / "workloads" / f"{name}.json")
    return Cell(name=name, config=read_json(root / "benchmark" / "configs" / f"{wl['config']}.json"),
                traffic=wl["traffic"], params=wl["params"], limits=wl["limits"], seed=seed,
                seconds=seconds, trace=trace)


def load_module(kind: str, name: str, root: pathlib.Path = ROOT):
    """``benchmark/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = root / "benchmark" / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def process_start() -> float:
    """The ``time.time()`` at which this process started (from
    ``/proc/self/stat`` and the boot time), or the time of this call."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        ticks = int(fields[19])  # starttime, field 22
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def foreign_modules() -> list[str]:
    """The loaded modules whose top-level name is one of :data:`FOREIGN`."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FOREIGN))


def percentile(values, q: float) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def seg_checks(prog: dict, ref: dict) -> dict:
    """The numbers that compare a segmentation output with the
    reference's, each a worst case over the rows given: rows whose gate
    (box, any_active) differs, the largest flow gap in px (where both have
    a flow), and the most mask pixels that differ in one row."""
    import torch

    gate = ((prog["box"].to(torch.int64) != ref["box"].to(torch.int64)).any(dim=1)
            | (prog["any_active"].bool() != ref["any_active"].bool()))
    out = {"gate_rows": float(gate.sum())}
    if "flow" in prog and "flow" in ref:
        gap = (prog["flow"].float() - ref["flow"].float()).abs()
        out["flow_px"] = float(gap.max()) if bool(torch.isfinite(gap).all()) else float("inf")
    out["mask_px"] = float((prog["mask"] != ref["mask"]).flatten(1).sum(dim=1).max())
    return out


def judge(checks: dict, limits: dict) -> bool:
    """Whether every number compared is within its limit; a number with
    no limit, or that is not a number (NaN), fails."""
    return all(k in limits and v <= limits[k] for k, v in checks.items())


def merge_worst(acc: dict, new: dict) -> dict:
    for k, v in new.items():
        acc[k] = max(acc.get(k, 0.0), v)
    return acc
