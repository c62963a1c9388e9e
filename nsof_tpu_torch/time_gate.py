"""Times the ROI gate (``ops/roi.py::roi_boxes``) on the main path's state
maps with each of the two forms of the component statistics in
:mod:`nsof_tpu_torch.ops.components`: ``component_stats`` (one-hot
``[B, HW, k_max]`` masks reduced along HW, the gate's own) and
``component_stats_scatter`` (``scatter_reduce`` into ``k_max + 1`` slots,
the tracking head's), and holds the two forms' outputs equal.

    python -m nsof_tpu_torch.time_gate [--batch 256] [--rounds 6] [--n 50]

The state maps are ``chip_smoke.py``'s: 6×8 cells (640×480, memsize 80), a
2×2 block active.  Rounds alternate the forms (one-hot, scatter, scatter,
one-hot, ...); each round is the median of ``--n`` calls timed one at a
time by CUDA events after 5 warm-up calls.  Then torch.profiler counts each
form's device kernels and device time for one call, of the gate and of the
stats alone.  Prints one JSON line per round and per trace, and the card's
name and power limit.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from nsof_tpu_torch.ops import components as comp
from nsof_tpu_torch.ops import roi as roi_ops

FORMS = {"onehot": comp.component_stats, "scatter": comp.component_stats_scatter}


def use(form: str) -> None:
    """Route ``roi_boxes``'s stats through ``form``."""
    comp.component_stats = FORMS[form]


def median_ms(fn, n: int, warm: int = 5) -> float:
    samples = []
    for i in range(warm + n):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        if i >= warm:
            samples.append(start.elapsed_time(stop))
    return float(np.median(samples))


def trace(fn) -> dict:
    """Device kernels and their device time for one call (after one
    untraced call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        return {"device_launches": "not measured", "busy_ms": "not measured"}
    return {"device_launches": sum(e.count for e in kern),
            "busy_ms": sum(e.self_device_time_total for e in kern) / 1e3}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--n", type=int, default=50)
    args = ap.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    cfg = roi_ops.RoiConfig()
    h, w = 480, 640
    mem = torch.zeros((args.batch, h // cfg.memsize, w // cfg.memsize),
                      dtype=torch.uint8, device=dev)
    mem[:, 2:4, 3:5] = 255

    def gate():
        return roi_ops.roi_boxes(mem, h, w, cfg)

    labels = comp.label_components(roi_ops.transition_map(mem, cfg.thres), cfg.connectivity)
    outs = {}
    for form in FORMS:
        use(form)
        outs[form] = gate()
    for key in ("boxes", "valid", "merged", "any_active"):
        if not torch.equal(outs["onehot"][key], outs["scatter"][key]):
            raise AssertionError(f"the two forms' {key} differ")
    order = ["onehot", "scatter"]
    for r in range(args.rounds):
        for form in order if r % 2 == 0 else order[::-1]:
            use(form)
            print(json.dumps({"round": r, "form": form, "batch": args.batch,
                              "grid": list(mem.shape[1:]),
                              "gate_ms": median_ms(gate, args.n),
                              "stats_ms": median_ms(
                                  lambda: FORMS[form](labels, cfg.k_max), args.n),
                              "card": card}), flush=True)
    for form in order:
        use(form)
        print(json.dumps({"trace": form, "gate": trace(gate),
                          "stats": trace(lambda: FORMS[form](labels, cfg.k_max)),
                          "card": card}), flush=True)
    use("onehot")


if __name__ == "__main__":
    main()
