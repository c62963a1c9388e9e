"""Times K9 (``csrc/nms.cu``) as built from each of one or more source
directories, at the YOLO post step's 300 candidates (B = 1 and 8), and
holds each build's keep mask against the plain ``nms`` (bit for bit).

    python -m nsof_tpu_torch.time_k9 [--csrc DIR [DIR ...]]

Two inputs a batch size, seeded: boxes clustered on eight centres of a
640-px square, uniform scores, the candidates scoring above 0.3
("clustered": most boxes suppressed, few steps), and the same boxes moved
by YOLO's class offset of 80 classes ("class_offset": few suppressed, a
step a kept box).  The builds are timed in the order A, B, …, B, A so
that a drift of the card's clock shows.  Each build goes to
``build/time_k9/``.  Prints one JSON line per (build, input, round), with
the card's name and power limit.  Needs one CUDA device; every source must
have ``nsof_nms``'s signature.
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
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
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
