"""Times K4 (``csrc/fused_box_update.cu``) as built from one or more source
directories, at grasp's three canvases (1088×1920, 544×960, 288×480), B =
128, both emits, bf16 M (``--f32`` adds float32 M), and holds every build's
output bit for bit to the first's.

    python -m nsof_tpu_torch.time_k4 [--csrc DIR ...] [--rounds 2]

The builds are timed in turns, A B … then … B A (``--rounds`` 2: A, B, B,
A), so a drift of the card's clock falls on both.  A source with the strip
design (it exports ``nsof_fused_box_update_strip_bytes``) runs the plan
:func:`~nsof_tpu_torch.ops.farneback_fast.k4_plan` picks, or the walk
``--walk`` forces (0: the tile design); an older source runs its tile
design.  Each
build goes to ``build/time_k4/``.  Prints one JSON line per (build, round,
canvas, emit, M type), with the card's name and power limit, then one
summary line of each build's median ms.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import pathlib
import shutil
import statistics
import subprocess

import torch

from nsof_tpu_torch import _build
from nsof_tpu_torch.ops import farneback_fast as tff

CANVASES = ((1088, 1920), (544, 960), (288, 480))  # grasp's levels, 32-aligned
WINSIZE, RADIUS, BATCH = 15, 3, 128
HBM_BYTES_PER_S = 3.35e12


def build(csrc: pathlib.Path) -> dict:
    """The K4 launchers of ``csrc`` built into their own directory: M type →
    (launcher, has the strip design)."""
    src = (csrc / "fused_box_update.cu").read_bytes()
    for header in sorted(csrc.glob("*.cuh")):
        src += header.read_bytes()
    out = _build.BUILD_DIR.parent / "time_k4" / hashlib.sha256(src).hexdigest()[:12]
    out.mkdir(parents=True, exist_ok=True)
    shutil.copy(csrc / "fused_box_update.cu", out)
    for header in csrc.glob("*.cuh"):
        shutil.copy(header, out)
    _build.build_all(["fused_box_update"], out)
    lib = ctypes.CDLL(str(_build._lib_path("fused_box_update", out)))
    strip = hasattr(lib, "nsof_fused_box_update_strip_bytes")
    fns = {}
    for dtype, sym in ((torch.bfloat16, "nsof_fused_box_update"),
                       (torch.float32, "nsof_fused_box_update_f32")):
        fn = getattr(lib, sym)
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * (11 if strip else 10) + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[dtype] = fn
    return {"fns": fns, "strip": strip, "ptxas": _build.BUILD_INFO.get("fused_box_update", [])}


def time_ms(fn, iters=10, warm=2):
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


def bound_ms(hp: int, wp: int, b: int, m_bytes: int, emit: str) -> float:
    """Least time of one launch by its bytes (benchmark/roofline's K4
    reckoning): M read, r0, r1 around its warp reach, the border scale, M'
    written; the flow emit M read and the flow written."""
    px = b * hp * wp
    if emit == "flow":
        return (px * m_bytes + px * 8) / HBM_BYTES_PER_S * 1e3
    r1_read = b * 5 * (hp + 2 * RADIUS + 1) * (wp + 2 * RADIUS + 1) * 4
    return (2 * px * m_bytes + px * 20 + r1_read + hp * wp * 4) / HBM_BYTES_PER_S * 1e3


def operands(hp: int, wp: int, b: int, dev, f32: bool) -> dict:
    gen = torch.Generator(dev).manual_seed(hp)
    mr, mc = tff.R1_MARGIN
    m = torch.randn((b, 5, hp, wp), generator=gen, device=dev) * 100.0
    ops = {"r0": torch.randn((b, 5, hp, wp), generator=gen, device=dev) * 50.0,
           "r1": torch.randn((b, 5, hp + 2 * mr, wp + 2 * mc), generator=gen, device=dev) * 50.0,
           "bsc": tff.border_scale(hp, wp, str(dev)), "m": {torch.bfloat16: m.bfloat16()}}
    if f32:
        ops["m"][torch.float32] = m
    return ops


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", type=pathlib.Path, nargs="+", default=[_build.CSRC])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--walk", type=int, default=None)
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    builds = [build(c.resolve()) for c in args.csrc]
    for c, bd in zip(args.csrc, builds):
        print(json.dumps({"csrc": str(c), "strip": bd["strip"], "ptxas": bd["ptxas"]}),
              flush=True)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    order = []
    for r in range(args.rounds):
        order += list(range(len(builds)))[:: 1 if r % 2 == 0 else -1]
    mr, mc = tff.R1_MARGIN
    stream = torch.cuda.current_stream().cuda_stream
    ms = {}
    for hp, wp in CANVASES:
        ops = operands(hp, wp, BATCH, dev, args.f32)
        for dtype, m in ops["m"].items():
            for emit in ("matrices", "flow"):
                flow = emit == "flow"
                shape = (BATCH, 2 if flow else 5, hp, wp)
                out = torch.empty(shape, dtype=torch.float32 if flow else dtype, device=dev)
                ref = None
                plan = tff.k4_plan(WINSIZE, RADIUS, emit, dtype, hp, wp, BATCH, n_sm)
                if args.walk is not None:
                    plan = plan._replace(walk=args.walk)
                for rnd, i in enumerate(order):
                    bd = builds[i]
                    head = (m.data_ptr(), 0 if flow else ops["r0"].data_ptr(),
                            0 if flow else ops["r1"].data_ptr(),
                            0 if flow else ops["bsc"].data_ptr(), out.data_ptr(),
                            BATCH, hp, wp, hp, wp, mr, mc, WINSIZE, RADIUS, int(flow))
                    tail = (plan.walk,) if bd["strip"] else ()

                    def run():
                        _build.check(bd["fns"][dtype](*head, *tail, stream), "fused_box_update")

                    t = time_ms(run)
                    if ref is None:
                        ref = out.clone()
                        equal = True
                    else:
                        equal = torch.equal(out, ref)
                    key = (str(args.csrc[i]), hp, wp, str(dtype), emit)
                    ms.setdefault(key, []).append(t)
                    print(json.dumps({
                        "csrc": str(args.csrc[i]), "turn": rnd, "canvas": [hp, wp],
                        "batch": BATCH, "m": str(dtype), "emit": emit,
                        "plan": plan._asdict() if bd["strip"] else "tile", "ms": t,
                        "bound_ms": bound_ms(hp, wp, BATCH, m.element_size(), emit),
                        "equal_to_first": equal, "card": card}), flush=True)
                    if not equal:
                        raise AssertionError(f"{args.csrc[i]} differs from {args.csrc[order[0]]}")
                del out, ref
        del ops
        torch.cuda.empty_cache()
    print(json.dumps({"median_ms": {" ".join(map(str, k)): statistics.median(v)
                                    for k, v in ms.items()}, "card": card}), flush=True)


if __name__ == "__main__":
    main()
