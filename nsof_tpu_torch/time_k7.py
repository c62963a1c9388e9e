"""Times K7 (``csrc/update_matrices.cu``) as built from a source directory,
with its block rows set to each of ``--rows``, at the autodriving path's
level 0 (801×801, B = 128) and radius 3 and 8, and holds each build's
output against the plain version (max |Δ|).

    python -m nsof_tpu_torch.time_k7 [--csrc DIR] [--rows 4 8 16]

A source without the ``kRows`` constant (an older K7) is timed once, as it
is.  Each build goes to ``build/time_k7/``.  Prints one JSON line per
(build, radius), with the card's name and power limit.  Needs one CUDA
device.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import pathlib
import re
import shutil
import subprocess

import torch

from nsof_tpu_torch import _build
from nsof_tpu_torch.ops import farneback_fast as tff

ROWS = re.compile(r"constexpr int kRows = \d+;")


def build(csrc, rows):
    """The launcher of K7 from ``csrc`` with ``rows`` block rows (``None``:
    the source as it is), built into its own directory."""
    src = (csrc / "update_matrices.cu").read_text()
    if rows is not None:
        src = ROWS.sub(f"constexpr int kRows = {rows};", src)
    tag = hashlib.sha256(src.encode()).hexdigest()[:12]
    out = _build.BUILD_DIR.parent / "time_k7" / tag
    out.mkdir(parents=True, exist_ok=True)
    (out / "update_matrices.cu").write_text(src)
    for header in csrc.glob("*.cuh"):
        shutil.copy(header, out)
    _build.build_all(["update_matrices"], out)
    fn = ctypes.CDLL(str(_build._lib_path("update_matrices", out))).nsof_update_matrices
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def time_ms(fn, iters=20, warm=3):
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
    ap.add_argument("--csrc", type=pathlib.Path, default=_build.CSRC)
    ap.add_argument("--rows", type=int, nargs="+", default=[4, 8, 16])
    args = ap.parse_args(argv)
    csrc = args.csrc.resolve()
    has_rows = ROWS.search((csrc / "update_matrices.cu").read_text()) is not None
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    b, h, w, pad = 128, 801, 801, 9
    # a smooth flow reaching past the radius (as chip_smoke.py's), random
    # expansions
    gen = torch.Generator(dev).manual_seed(3)
    coarse = torch.randn((b, 2, 26, 26), generator=gen, device=dev) * 2.0
    flow = torch.nn.functional.interpolate(coarse, size=(h, w), mode="bilinear")
    dx, dy = flow[:, 0].contiguous(), flow[:, 1].contiguous()
    r0 = torch.randn((b, 5, h, w), generator=gen, device=dev) * 50.0
    r1p = torch.randn((b, 5, h + 2 * pad, w + 2 * pad), generator=gen, device=dev) * 50.0
    bsc = tff.border_scale(h, w, str(dev))
    out = torch.empty_like(r0)
    for radius in (3, 8):
        ref = tff._warp_full(dx, dy, r0, r1p, bsc, radius)
        for rows in (args.rows if has_rows else [None]):
            fn = build(csrc, rows)

            def run():
                _build.check(fn(dx.data_ptr(), dy.data_ptr(), r0.data_ptr(),
                                r1p.data_ptr(), bsc.data_ptr(), out.data_ptr(), b, h, w,
                                pad, radius, torch.cuda.current_stream().cuda_stream),
                             "update_matrices")

            ms = time_ms(run)
            print(json.dumps({"csrc": str(args.csrc), "rows": rows, "radius": radius,
                              "batch": b, "level": [h, w], "ms": ms,
                              "max_abs_err": (out - ref).abs().max().item(),
                              "card": card}), flush=True)
        del ref


if __name__ == "__main__":
    main()
