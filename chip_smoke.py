"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels (K1–K4) from ``nsof_tpu_torch/csrc``, holds
each against its plain PyTorch version on the card, drives the main path
(``seg_batch_fast`` on bench.py's 640×480 workload: 256×384 window, grasp
preset, memsize 80, warp radius 3) at B = 256, checks that it went through
every kernel, made no host synchronisation and agrees with the plain
route, and times it.

Each phase prints one JSON line.  The line before the last is the card's
name and power limit as ``nvidia-smi`` reports them, the one before that
the ``kernels`` summary, and the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failure raises, so the exit code is nonzero.  Without a CUDA device the
script exits with code 1 before printing any result.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from nsof_tpu_torch import _build
from nsof_tpu_torch.config import DATASETS
from nsof_tpu_torch.ops import farneback_fast as tff
from nsof_tpu_torch.ops import roi as troi
from nsof_tpu_torch.ops.farneback import _gaussian_blur_kernel
from nsof_tpu_torch.pipelines.segmentation import seg_batch_fast

H, W, MEMSIZE = 480, 640, 80
WIN = (256, 384)
B_MAIN = 256
B_CHECK = 16
RADIUS = 3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
EXPECTED_LAUNCHES = {"crop_windows": 2, "poly_expansion": 8,
                     "update_matrices_sep": 4, "fused_box_update": 12}
SOURCES = {
    "crop_windows": ("nsof_tpu_torch/csrc/crop_windows.cu",
                     "nsof_tpu/ops/roi.py:203"),
    "poly_expansion": ("nsof_tpu_torch/csrc/poly_expansion.cu",
                       "nsof_tpu/ops/farneback_fast.py:600"),
    "update_matrices_sep": ("nsof_tpu_torch/csrc/update_matrices_sep.cu",
                            "nsof_tpu/ops/farneback_fast.py:268"),
    "fused_box_update": ("nsof_tpu_torch/csrc/fused_box_update.cu",
                         "nsof_tpu/ops/farneback_fast.py:864"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()] if out else ""


def time_ms(fn, iters: int = 20, warm: int = 3) -> float:
    """Mean device time per call over ``iters`` calls, after ``warm``."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def host_syncs(fn) -> dict:
    """Host-device synchronisations made by one call of ``fn``, by the
    Python line that made them (CUDA sync debug mode warns at each)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    # each sync warns "called a synchronizing CUDA operation"; the mode
    # also warns once that it is a prototype, which is not a sync
    where = collections.Counter(f"{w.filename}:{w.lineno}" for w in caught
                                if "called a synchronizing" in str(w.message))
    return dict(where)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time for the work: bytes over the memory rate or float32
    operations over the card's float32 rate, whichever is larger."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / FP32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def bench_cfg():
    cfg = dataclasses.replace(
        DATASETS["grasp"], name="bench640", image_h=H, image_w=W,
        window_h=WIN[0], window_w=WIN[1], warp_radius=RADIUS,
    )
    return dataclasses.replace(cfg, roi=dataclasses.replace(cfg.roi, memsize=MEMSIZE))


def bench_inputs(b: int, variant: int, dev):
    """bench.py's inputs (bench.py:72-92): a random texture moved by
    (2, -1) px, and a 6×8 state map with an active 2×2 block."""
    rng = np.random.default_rng(0)
    base = rng.random((H + 64, W + 64)).astype(np.float32) * 255
    v = variant
    prev = np.broadcast_to(base[16 + v : 16 + v + H, 16 : 16 + W], (b, H, W))
    nxt = np.broadcast_to(base[18 + v : 18 + v + H, 15 : 15 + W], (b, H, W))
    mem = np.zeros((b, H // MEMSIZE, W // MEMSIZE), np.uint8)
    mem[:, 2:4, 3:5] = 255
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return t(mem), t(prev.astype(np.uint8)), t(nxt.astype(np.uint8))


def bf16_check(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Kernel vs plain for bf16 M: ≥ 99 % bit-equal, and every element
    within one bf16 ulp, or 1e-6 of its channel's largest magnitude where
    the products cancel.  Returns max |Δ|."""
    g, r = got.float(), ref.float()
    equal = (got.view(torch.int16) == ref.view(torch.int16)).float().mean().item()
    if equal < 0.99:
        raise AssertionError(f"bf16 M: only {equal:.4%} bit-equal")
    chmax = r.abs().amax(dim=(0, 2, 3), keepdim=True)
    ulp = torch.where(r == 0, torch.zeros_like(r),
                      2.0 ** (torch.floor(torch.log2(r.abs())) - 7))
    tol = torch.maximum(ulp, 1e-6 * chmax)
    if not ((g - r).abs() <= tol).all():
        raise AssertionError("bf16 M: an element is beyond its tolerance")
    return (g - r).abs().max().item()


@contextlib.contextmanager
def plain_route():
    """Swap every kernel wrapper for its plain version (the reference run
    of the main path on the card)."""
    saved = (troi.crop_windows_batch, tff.poly_expansion,
             tff.update_matrices_sep, tff.fused_box_update)
    troi.crop_windows_batch = troi._crop_windows_plain
    tff.poly_expansion = tff._poly_expansion_plain
    tff.update_matrices_sep = tff._update_matrices_sep_plain
    tff.fused_box_update = tff._fused_box_update_plain
    try:
        yield
    finally:
        (troi.crop_windows_batch, tff.poly_expansion,
         tff.update_matrices_sep, tff.fused_box_update) = saved


def level0_operands(b: int, dev):
    """Level-0 operands of the main path: 256×384 window images, their
    expansions, a smooth flow reaching past the warp radius."""
    rng = np.random.default_rng(1)
    hk, wk = WIN
    img0 = torch.from_numpy((rng.random((b, hk, wk)) * 255).astype(np.float32)).to(dev)
    img1 = torch.roll(img0, (2, -1), dims=(1, 2)).contiguous()
    coarse = torch.from_numpy(rng.normal(size=(b, 2, 10, 14)).astype(np.float32) * 2.0)
    flow = torch.nn.functional.interpolate(coarse, size=(hk, wk), mode="bilinear")
    dx, dy = flow[:, 0].contiguous().to(dev), flow[:, 1].contiguous().to(dev)
    blur = _gaussian_blur_kernel(3, 0.0)
    r0 = tff.poly_expansion(img0, 5, 1.2, hk, wk, blur)
    r1 = tff.poly_expansion(img1, 5, 1.2, hk, wk, blur, margin=tff.R1_MARGIN)
    bsc = tff.border_scale(hk, wk, str(dev))
    m = tff.update_matrices_sep(dx, dy, r0, r1, bsc, RADIUS)
    return dict(img0=img0, img1=img1, dx=dx, dy=dy, blur=blur, r0=r0, r1=r1,
                bsc=bsc, m=m)


def where_the_time_goes(cfg, mem, prev, nxt, ms_batch: float) -> dict:
    """Device time of one main-path call by kernel name (torch.profiler),
    the kernels K1–K4 against everything else, and the device's idle share
    of the timed batch."""
    from torch.profiler import ProfilerActivity, profile

    seg_batch_fast(mem, prev, nxt, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        seg_batch_fast(mem, prev, nxt, cfg)
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        return {"phase": "device_trace", "busy_ms": "not measured",
                "reason": "the profiler recorded no device events"}
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    ours = {k: 0.0 for k in EXPECTED_LAUNCHES}
    for e in kern:
        for k in ours:
            if f"{k}_kernel" in e.key:
                ours[k] += e.self_device_time_total / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:15]
    return {
        "phase": "device_trace", "batch": B_MAIN, "busy_ms": busy,
        "idle_share_of_timed_batch": 1.0 - busy / ms_batch,
        "kernels_ms": ours, "other_ms": busy - sum(ours.values()),
        "top": [{"name": e.key[:80], "ms": e.self_device_time_total / 1e3,
                 "count": e.count} for e in top],
    }


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(1)
    dev = torch.device("cuda", torch.cuda.current_device())
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    secs = _build.build_all()
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "per_kernel": {k: round(v, 3) for k, v in secs.items()}})

    # ── each kernel against its plain version, level-0 shapes, B = 16 ──
    hk, wk = WIN
    errs = {}
    rng = np.random.default_rng(2)
    frames = torch.from_numpy(rng.integers(0, 256, (B_CHECK, H, W), dtype=np.uint8)).to(dev)
    oys = torch.from_numpy(rng.integers(0, H - hk + 1, B_CHECK).astype(np.int32)).to(dev)
    oxs = torch.from_numpy(rng.integers(0, W - wk + 1, B_CHECK).astype(np.int32)).to(dev)
    got = troi.crop_windows_batch(frames, oys, oxs, hk, wk)
    ref = troi._crop_windows_plain(frames, oys, oxs, hk, wk)
    errs["crop_windows"] = (got.int() - ref.int()).abs().max().item()
    if errs["crop_windows"] != 0:
        raise AssertionError("K1 differs from its plain version")
    emit({"phase": "check", "kernel": "crop_windows", "max_abs_err": errs["crop_windows"],
          "tolerance": 0})

    ops = level0_operands(B_CHECK, dev)
    k2 = 0.0
    for blur, margin in ((None, (0, 0)), (ops["blur"], (0, 0)), (ops["blur"], tff.R1_MARGIN)):
        got = tff.poly_expansion(ops["img1"], 5, 1.2, hk, wk, blur, margin)
        ref = tff._poly_expansion_plain(ops["img1"], 5, 1.2, hk, wk, blur, margin)
        k2 = max(k2, (got - ref).abs().max().item())
    errs["poly_expansion"] = k2
    if not k2 <= 1e-4:
        raise AssertionError(f"K2 differs from its plain version by {k2}")
    emit({"phase": "check", "kernel": "poly_expansion", "max_abs_err": k2,
          "tolerance": "1e-4 abs on 0-255 images"})

    args = (ops["dx"], ops["dy"], ops["r0"], ops["r1"], ops["bsc"], RADIUS)
    errs["update_matrices_sep"] = bf16_check(
        tff.update_matrices_sep(*args), tff._update_matrices_sep_plain(*args))
    emit({"phase": "check", "kernel": "update_matrices_sep",
          "max_abs_err": errs["update_matrices_sep"],
          "tolerance": ">=99% bf16 bit-equal; each element within 1 bf16 ulp "
                       "or 1e-6 of its channel max"})

    kargs = (ops["m"], ops["r0"], ops["r1"], ops["bsc"], 15, RADIUS)
    k4m = bf16_check(tff.fused_box_update(*kargs, "matrices"),
                     tff._fused_box_update_plain(*kargs, "matrices"))
    k4f = (tff.fused_box_update(*kargs, "flow")
           - tff._fused_box_update_plain(*kargs, "flow")).abs().max().item()
    if not k4f <= 1e-3:
        raise AssertionError(f"K4 flow differs from its plain version by {k4f} px")
    errs["fused_box_update"] = max(k4m, k4f)
    emit({"phase": "check", "kernel": "fused_box_update",
          "max_abs_err_matrices": k4m, "max_abs_err_flow_px": k4f,
          "tolerance": "matrices as K3; flow 1e-3 px"})
    torch.cuda.synchronize()
    del ops

    # ── the main path at full width ──
    cfg = bench_cfg()
    mem, prev, nxt = bench_inputs(B_MAIN, 0, dev)
    torch.cuda.synchronize()
    _build.reset_launches()
    out = seg_batch_fast(mem, prev, nxt, cfg, return_flow=True)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    if launches != EXPECTED_LAUNCHES:
        raise AssertionError(f"launches {launches} != {EXPECTED_LAUNCHES}")
    with plain_route():
        ref = seg_batch_fast(mem, prev, nxt, cfg, return_flow=True)
    torch.cuda.synchronize()
    if _build.LAUNCHES != launches:
        raise AssertionError("the plain route launched a kernel")
    flow_err = (out["flow"] - ref["flow"]).abs()
    mask_agree = (out["mask"] == ref["mask"]).float().mean().item()
    if not (torch.isfinite(out["flow"]).all() and flow_err.max().item() <= 1e-3
            and mask_agree >= 0.995):
        raise AssertionError(f"main path vs plain route: flow {flow_err.max().item()} px, "
                             f"mask agreement {mask_agree}")
    for key in ("box", "any_active", "region_pct"):
        if not torch.equal(out[key], ref[key]):
            raise AssertionError(f"{key} differs from the plain route")
    box = out["box"][0].tolist()
    inside = out["mask"][:, box[1]:box[3], box[0]:box[2]]
    if not (out["any_active"].all() and (inside > 0).any(dim=(1, 2)).all()):
        raise AssertionError("the mask is empty inside the ROI")
    if out["mask"].sum() != inside.sum():
        raise AssertionError("the mask has pixels outside the ROI")
    probe = host_syncs(lambda: out["box"].sum().item())
    if sum(probe.values()) != 1:
        raise AssertionError(f"the sync counter saw {probe} in one .item()")
    syncs = host_syncs(lambda: seg_batch_fast(mem, prev, nxt, cfg, return_flow=True))
    emit({"phase": "main_path", "batch": B_MAIN, "frame": [H, W], "window": list(WIN),
          "launches_per_call": launches, "flow_max_abs_err_px": flow_err.max().item(),
          "flow_mean_abs_err_px": flow_err.mean().item(), "mask_agreement": mask_agree,
          "mask_fraction_in_roi": (inside > 0).float().mean().item(), "box": box,
          "host_syncs_per_call": sum(syncs.values()), "host_sync_sites": syncs})
    if syncs:
        raise AssertionError(f"the main path synchronised with the host: {syncs}")

    variants = [bench_inputs(B_MAIN, v, dev) for v in range(3)]
    samples = []
    for i in range(13):
        m_, p_, n_ = variants[i % 3]
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        seg_batch_fast(m_, p_, n_, cfg)
        stop.record()
        torch.cuda.synchronize()
        if i >= 3:  # warm-up
            samples.append(start.elapsed_time(stop))
    ms_batch = float(np.median(samples))
    emit({"phase": "main_path_time", "batch": B_MAIN, "ms_per_batch": ms_batch,
          "fps": B_MAIN / ms_batch * 1e3, "samples_ms": samples,
          "card": smi})
    emit(where_the_time_goes(cfg, *variants[0], ms_batch))
    del variants, out, ref

    # ── per-kernel times at the main path's level-0 shapes ──
    b = B_MAIN
    ops = level0_operands(b, dev)
    frames = prev
    oy = torch.full((b,), 100, dtype=torch.int32, device=dev)
    ox = torch.full((b,), 160, dtype=torch.int32, device=dev)
    dst = torch.empty((b, hk, wk), dtype=torch.uint8, device=dev)
    n_, nb = 5, 1
    hp, wp = hk, wk
    h1, w1 = hp + 2 * tff.R1_MARGIN[0], wp + 2 * tff.R1_MARGIN[1]
    e = RADIUS + 1
    px = b * hp * wp
    # the warp reads r1 at rows y + ky and columns x + kx, ky, kx in
    # [-r, r + 1]: the canvas and a ring of r (top, left) and r + 1
    # (bottom, right), not the whole margin canvas
    r1_read = b * 5 * (hp + 2 * RADIUS + 1) * (wp + 2 * RADIUS + 1) * 4
    # operations with every intermediate computed once: the blur (2 passes
    # of 4·nb+1), the expansion's vertical (9n+1) and horizontal (18n+2)
    # sums and its 9 final operations; the warp's pass 1 once per row
    # ((2r+2) taps × 14), pass 2 ((2r+2) × 14) and the build (34); the box
    # sums (recurrence 2, log tree 6, scale 1 per channel) and the solve (11)
    warp_ops = (2 * RADIUS + 2) * 14 * (1 + 2 * e / hp) + (2 * RADIUS + 2) * 14 + 34
    box_ops = (5 * (2 + 6 + 1) + 11) * (1 + 2 * e / 32)
    work = {
        "crop_windows": (2 * b * hk * wk, 0),
        "poly_expansion": (b * hk * wk * 4 + b * 5 * h1 * w1 * 4,
                           b * h1 * w1 * (2 * (4 * nb + 1) + 27 * n_ + 12)),
        "update_matrices_sep": (b * hk * wk * 4 * 2 + hk * wk * 4 + px * 20
                                + r1_read + px * 10, px * warp_ops),
        "fused_box_update": (px * 10 + px * 20 + r1_read + hk * wk * 4
                             + px * 10, px * (box_ops + warp_ops)),
    }
    calls = {
        "crop_windows": (lambda: troi.crop_windows_batch(frames, oy, ox, hk, wk),
                         lambda: troi._crop_windows_plain(frames, oy, ox, hk, wk),
                         lambda: dst.copy_(frames[:, 100:100 + hk, 160:160 + wk])),
        "poly_expansion": (
            lambda: tff.poly_expansion(ops["img1"], 5, 1.2, hp, wp, ops["blur"], tff.R1_MARGIN),
            lambda: tff._poly_expansion_plain(ops["img1"], 5, 1.2, hp, wp, ops["blur"],
                                              tff.R1_MARGIN), None),
        "update_matrices_sep": (
            lambda: tff.update_matrices_sep(ops["dx"], ops["dy"], ops["r0"], ops["r1"],
                                            ops["bsc"], RADIUS),
            lambda: tff._update_matrices_sep_plain(ops["dx"], ops["dy"], ops["r0"],
                                                   ops["r1"], ops["bsc"], RADIUS), None),
        "fused_box_update": (
            lambda: tff.fused_box_update(ops["m"], ops["r0"], ops["r1"], ops["bsc"], 15,
                                         RADIUS, "matrices"),
            lambda: tff._fused_box_update_plain(ops["m"], ops["r0"], ops["r1"], ops["bsc"],
                                                15, RADIUS, "matrices"), None),
    }
    kernels = []
    for kname, (kernel, plain, library) in calls.items():
        nbytes, flops = work[kname]
        bms, by = bound_ms(nbytes, flops)
        entry = {
            "name": kname, "route": "cuda", "source": SOURCES[kname][0],
            "replaces": SOURCES[kname][1], "launches": launches[kname],
            "max_abs_err": errs[kname], "ms": time_ms(kernel),
            "plain_ms": time_ms(plain, iters=5, warm=1), "bound_ms": bms,
            "bound_by": by, "library_ms": time_ms(library) if library else None,
        }
        if kname == "fused_box_update":
            fbytes, fflops = px * 10 + px * 8, px * box_ops
            fb, fby = bound_ms(fbytes, fflops)
            entry["flow_emit"] = {
                "ms": time_ms(lambda: tff.fused_box_update(
                    ops["m"], None, None, ops["bsc"], 15, RADIUS, "flow")),
                "plain_ms": time_ms(lambda: tff._fused_box_update_plain(
                    ops["m"], None, None, ops["bsc"], 15, RADIUS, "flow"), iters=5, warm=1),
                "bound_ms": fb, "bound_by": fby,
            }
        kernels.append(entry)
        emit({"phase": "kernel_time", "batch": b, **entry})
    torch.cuda.synchronize()

    emit({"kernels": kernels})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
