"""Times K9 (``csrc/nms.cu``) as built from each of one or more source
directories, at the YOLO post step's 300 candidates (B = 1 and 8), and
holds each build's keep mask against the plain ``nms`` (bit for bit).

    python -m nsof_tpu_torch.time_k9 [--csrc DIR [DIR ...]] [--phases]

Two inputs a batch size, seeded: boxes clustered on eight centres of a
640-px square, uniform scores, the candidates scoring above 0.3
("clustered": most boxes suppressed, few steps), and the same boxes moved
by YOLO's class offset of 80 classes ("class_offset": few suppressed, a
step a kept box).  The builds are timed in the order A, B, …, B, A so
that a drift of the card's clock shows.  Each build goes to
``build/time_k9/``.  Prints one JSON line per (build, input, round), with
the card's name and power limit.  Needs one CUDA device; every source must
have ``nsof_nms``'s signature.  Its scratch pointer gets ``[B, N]`` bytes,
the alive flags of the greedy design; the rank → mask → walk design needs
no scratch at N = 300.

``--phases`` times the rank → mask → walk design of the first directory
phase by phase instead: a copy of its ``nms.cu`` returns before the phase
that PHASES names (a ``__device__`` flag set between runs), and each stop's
mean device time over 50 launches (torch.profiler) is printed; the time up
to a phase less the time up to the one before is that phase's.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import pathlib
import shutil
import subprocess

import numpy as np
import torch

from nsof_tpu_torch import _build
from nsof_tpu_torch.ops import components as tcomp

N, IOU = 300, 0.45
# where the --phases copy may return: the kernel's comment opening each phase
PHASES = ("  // 1. order:", "  // 2. the suppression mask", "  // 3. the walk, one warp",
          "  // the keep mask in the input's order")


def build(csrc):
    """The launcher of K9 from ``csrc``, built into its own directory."""
    src = (csrc / "nms.cu").read_text()
    out = _build.BUILD_DIR.parent / "time_k9" / hashlib.sha256(src.encode()).hexdigest()[:12]
    out.mkdir(parents=True, exist_ok=True)
    shutil.copy(csrc / "nms.cu", out)
    _build.build_all(["nms"], out)
    fn = ctypes.CDLL(str(_build._lib_path("nms", out))).nsof_nms
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def phases(csrc: pathlib.Path, card: str) -> None:
    """Each phase's device time at the four inputs (see the module's doc)."""
    from nsof_tpu_torch.time_trees import device_ms

    src = (csrc / "nms.cu").read_text()
    for k, anchor in enumerate(PHASES, 1):
        if src.count(anchor) != 1:
            raise SystemExit(f"{csrc / 'nms.cu'} has no single {anchor.strip()!r}")
        src = src.replace(anchor, f"  if (stop_before == {k}) return;\n" + anchor)
    src = src.replace("namespace {\n", "namespace {\n__device__ int stop_before;\n", 1)
    src += ('\nextern "C" int nsof_nms_stop_before(int k) {\n'
            '  return (int)cudaMemcpyToSymbol(stop_before, &k, sizeof k);\n}\n')
    out = _build.BUILD_DIR.parent / "time_k9" / ("phases_" + hashlib.sha256(
        src.encode()).hexdigest()[:12])
    out.mkdir(parents=True, exist_ok=True)
    (out / "nms.cu").write_text(src)
    _build.build_all(["nms"], out)
    lib = ctypes.CDLL(str(_build._lib_path("nms", out)))
    fn = lib.nsof_nms
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
    dev = torch.device("cuda")
    for b in (1, 8):
        for kind in ("clustered", "class_offset"):
            boxes, scores, valid = inputs(b, kind, dev)
            keep = torch.empty_like(valid)
            for stop in (1, 2, 3, 4, 0):
                _build.check(lib.nsof_nms_stop_before(stop), "nms")
                ms = device_ms(lambda: fn(boxes.data_ptr(), scores.data_ptr(), valid.data_ptr(),
                                          keep.data_ptr(), None, b, N, 0, IOU,
                                          torch.cuda.current_stream().cuda_stream),
                               "nms_kernel", n=50)
                print(json.dumps({"csrc": str(csrc), "batch": b, "n": N, "input": kind,
                                  "stop_before": PHASES[stop - 1].strip() if stop else "end",
                                  "device_ms": ms, "card": card}), flush=True)


def inputs(b, kind, dev):
    """Boxes ``[b, N, 4]``, scores and candidates ``[b, N]`` on ``dev``."""
    rng = np.random.default_rng(b)
    centres = rng.uniform(0, 640, (b, 8, 2))
    xy = centres[np.arange(b)[:, None], rng.integers(0, 8, (b, N))] + rng.normal(0, 6, (b, N, 2))
    wh = rng.uniform(8, 120, (b, N, 2))
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], -1).astype(np.float32)
    if kind == "class_offset":
        boxes += rng.integers(0, 80, (b, N, 1)).astype(np.float32) * np.float32(7680.0)
    scores = rng.random((b, N)).astype(np.float32)
    return (torch.from_numpy(boxes).to(dev), torch.from_numpy(scores).to(dev),
            torch.from_numpy(scores > 0.3).to(dev))


def time_ms(fn, iters=200, warm=20):
    for _ in range(warm):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", type=pathlib.Path, nargs="+", default=[_build.CSRC])
    ap.add_argument("--phases", action="store_true",
                    help="time the first directory's kernel phase by phase")
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    if args.phases:
        phases(args.csrc[0].resolve(), card)
        return
    fns = [build(c.resolve()) for c in args.csrc]
    order = list(range(len(fns))) + list(reversed(range(len(fns))))
    for b in (1, 8):
        for kind in ("clustered", "class_offset"):
            boxes, scores, valid = inputs(b, kind, dev)
            ref = tcomp.nms(boxes, scores, valid, IOU, False)
            keep = torch.empty_like(valid)
            alive = torch.empty((b, N), dtype=torch.uint8, device=dev)
            for rnd, k in enumerate(order):
                def run(fn=fns[k]):
                    _build.check(fn(boxes.data_ptr(), scores.data_ptr(), valid.data_ptr(),
                                    keep.data_ptr(), alive.data_ptr(), b, N, 0, IOU,
                                    torch.cuda.current_stream().cuda_stream), "nms")

                ms = time_ms(run)
                print(json.dumps({"csrc": str(args.csrc[k]), "round": rnd, "batch": b, "n": N,
                                  "input": kind, "steps": int(ref.sum(dim=1).max()) + 1,
                                  "ms": ms, "equal_plain": bool(torch.equal(keep, ref)),
                                  "card": card}), flush=True)


if __name__ == "__main__":
    main()
