"""Times K8, the stream, K9 and the tracking path as each of several
source trees builds and runs them, on one card, in the order A, B, …, B, A.

    python -m nsof_tpu_torch.time_trees TREE [TREE ...] [--parts PART ...]

A tree is a checkout of the repository (the parent commit unpacked with
``git archive`` under ``build/parent``, say, beside ``.``).  Each round runs
this file in a subprocess from the tree's root with the tree first on
``sys.path``, so that the tree's own package and ``chip_smoke.py`` are
imported and its kernels built into its own ``build/``; the parts use only
what every tree with K9 has.  Parts, at ``chip_smoke.py``'s
shapes and inputs:

- ``k8``: ``scan_device`` at the stream's shape (129 frames of the moving
  block compressed to the 6×8 grid, n_substeps 1000), the mean of 20
  launches after 3 (CUDA events) and the kernel's mean device time over 20
  launches (torch.profiler);
- ``stream``: ``stream_masks`` on those frames (128 pairs), the median of
  ``chip_smoke.median_ms`` over three stream variants;
- ``k9``: ``nms_batch`` at K9's ``yolo_n300_b1`` case and at
  ``time_k9.py``'s four inputs (clustered and class-offset, B = 1 and 8),
  the mean of 200 launches after 20 (each with its wrapper's host work) and
  the kernel's mean device time over 20 launches, with the greedy steps each
  input takes;
- ``tracking``: ``tracking_batch_fast`` at B = 64 in 'fused', the median
  over three input variants.

Prints one JSON line per (tree, round, part) with the card's name and power
limit; the kernels' build time is in each round's ``build`` line.  Needs
one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys

PARTS = ("k8", "stream", "k9", "tracking")


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def device_ms(fn, kernel: str, n: int = 20):
    """The mean device time of the CUDA kernels whose name holds ``kernel``
    over ``n`` calls of ``fn`` (torch.profiler), in ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages() if kernel in e.key)
    return us / 1e3 / n if us else "not measured"


def run_parts(tree: str, rnd: int, parts) -> None:
    """This round's parts, in this process (the tree's package imported)."""
    import time

    import torch

    import chip_smoke as cs
    from nsof_tpu_torch import _build
    from nsof_tpu_torch import time_k9
    from nsof_tpu_torch.device import frame_sim as tfs
    from nsof_tpu_torch.ops import components as tcomp
    from nsof_tpu_torch.pipelines import stream as tstream
    from nsof_tpu_torch.pipelines.tracking import tracking_batch_fast

    dev = torch.device("cuda")
    card = _card()

    def emit(part, **kw):
        print(json.dumps({"tree": tree, "round": rnd, "part": part, **kw, "card": card}),
              flush=True)

    start = time.perf_counter()
    _build.build_all()
    emit("build", seconds=time.perf_counter() - start)
    cfg, sim = cs.bench_cfg(), cs.stream_sim()
    if "k8" in parts:
        comp = tfs.compress_frames(cs.stream_frames(0, dev).float() / 255.0, sim.m, sim.n)
        w0 = torch.full(comp.shape[1:], sim.params.w_init, device=dev)
        def k8():
            return tfs.scan_device(comp, sim, w0)

        emit("k8", ms=cs.time_ms(k8), device_ms=device_ms(k8, "device_scan_kernel"),
             pairs=comp.shape[0] - 1, cells=w0.numel(), n_substeps=sim.n_substeps)
    if "stream" in parts:
        variants = [(cs.stream_frames(v, dev),) for v in (0, 7, 14)]
        ms, samples = cs.median_ms(lambda f: tstream.stream_masks(f, cfg, sim), variants)
        emit("stream", ms_per_call=ms, pairs=cs.STREAM_T - 1, samples_ms=samples)
    if "k9" in parts:
        inputs = {"yolo_n300_b1": cs.k9_inputs("yolo_n300_b1", dev)[:3]}
        for b in (1, 8):
            for kind in ("clustered", "class_offset"):
                inputs[f"time_k9_{kind}_b{b}"] = time_k9.inputs(b, kind, dev)
        for name, (boxes, scores, valid) in inputs.items():
            keep = tcomp.nms(boxes, scores, valid, cs.K9_IOU, False)

            def k9(boxes=boxes, scores=scores, valid=valid):
                return tcomp.nms_batch(boxes, scores, valid, cs.K9_IOU, False)

            emit("k9", input=name, batch=scores.shape[0], n=scores.shape[1],
                 steps=int(keep.sum(dim=1).max()) + 1, ms=cs.time_ms(k9, iters=200, warm=20),
                 device_ms=device_ms(k9, "nms_kernel"))
    if "tracking" in parts:
        variants = [cs.bench_inputs(cs.B_HEADS, v, dev) for v in (0, 1, 2)]
        ms, samples = cs.median_ms(
            lambda m, p, n: tracking_batch_fast(m, p, n, cfg, kernel_mode="fused"), variants)
        emit("tracking", batch=cs.B_HEADS, ms_per_batch=ms, samples_ms=samples)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", type=pathlib.Path)
    ap.add_argument("--parts", nargs="+", choices=PARTS, default=list(PARTS))
    ap.add_argument("--round", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.round is not None:  # a round, inside its tree
        run_parts(str(args.trees[0]), args.round, args.parts)
        return
    trees = [t.resolve() for t in args.trees]
    order = list(range(len(trees))) + list(reversed(range(len(trees))))
    me = str(pathlib.Path(__file__).resolve())
    for rnd, k in enumerate(order):
        code = ("import runpy, sys; sys.argv = sys.argv[1:]; "
                "runpy.run_path(sys.argv[0], run_name='__main__')")
        cmd = [sys.executable, "-c", code, me, str(args.trees[k]), "--round", str(rnd),
               "--parts", *args.parts]
        env = {**os.environ, "PYTHONPATH": str(trees[k])}
        subprocess.run(cmd, cwd=trees[k], env=env, check=True)


if __name__ == "__main__":
    main()
