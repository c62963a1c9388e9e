"""A live camera through ``stream_masks``: chunk after chunk of one stream.

Set-up renders a periodic sequence of ``params["period"]`` frames from the
seed (``benchmark.inputs.sequence``) onto the device and runs one chunk.
The window restarts the stream at the device's initial state and calls
``stream_masks(..., return_flow=True)`` on consecutive chunks of
``params["chunk_pairs"] + 1`` frames, each continuing from the state the
previous call returned (``w0 = w_final``), until ``--seconds`` have passed;
it ends in one synchronisation, and ``pairs_per_s`` is every pair over the
whole window.  With ``--trace 1`` a few more chunks run under the profiler.

The check takes two calls once the window has closed: the window's first,
which starts from the initial state, and the last.  The device scan of each
is integrated again by the reference from the same compressed frames and
the state the call started from; the gate, flow and masks are recomputed
by the reference from the frames and the call's own gating maps, which
the scan check has compared with the reference's.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import common, inputs
from benchmark.reference import frame_sim as ref_sim
from benchmark.reference import segmentation as ref_seg
from benchmark.trace import traced

OUT = {"masks": "mask", "flow": "flow", "boxes": "box", "any_active": "any_active"}


def _sim(cell):
    from nsof_tpu_torch.device.frame_sim import FrameSimConfig

    s = cell.params["sim"]
    return FrameSimConfig(m=s["m"], n=s["n"], th1=s["th1"], th2=s["th2"], dt=s["dt"],
                          n_substeps=s["n_substeps"])


def entry(cell, frames):
    """The timed call on chunk ``c`` from the state ``w0`` (None: the
    initial state)."""
    from nsof_tpu_torch.pipelines import stream

    cfg, sim = cell.pipeline_config(), _sim(cell)
    mode, k = cell.config["kernel_mode"], cell.params["chunk_pairs"]

    def call(c, w0):
        return stream.stream_masks(frames[c * k : c * k + k + 1], cfg, sim, w0,
                                   kernel_mode=mode, return_flow=True, device=cell.device)
    return call


def check_call(cell, chunk, w0, out) -> dict:
    """One call's outputs against the reference: the scan from ``w0``
    (None: the initial state) and the segmentation on the call's maps."""
    import torch

    s = cell.params["sim"]
    comp = ref_sim.compress(chunk, s["m"], s["n"]).double().cpu().numpy()
    w_start = (np.full(comp.shape[1:], ref_sim.DEVICE["w_init"]) if w0 is None
               else w0.double().cpu().numpy())
    w_ref, gray_ref = ref_sim.scan(comp, s, w_start)
    gray_prog = out["mem_gray"].cpu().numpy().astype(np.int64)
    checks = {
        "scan_w": float(np.abs(out["w_final"].double().cpu().numpy() - w_ref).max()),
        "scan_gray": float(np.abs(gray_prog - np.floor(gray_ref)).max()),
    }
    blk = cell.params["check_block"]
    for a in range(0, chunk.shape[0] - 1, blk):
        b = min(a + blk, chunk.shape[0] - 1)
        want = ref_seg.seg_step(out["mem_gray"][a:b], chunk[a:b], chunk[a + 1 : b + 1],
                                cell.config)
        got = {v: out[k][a:b] for k, v in OUT.items()}
        common.merge_worst(checks, common.seg_checks(got, want))
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()
    return checks


def run(cell) -> dict:
    import torch

    sync = torch.cuda.synchronize if cell.device.type == "cuda" else (lambda: None)
    frames = inputs.sequence(cell.seed, cell.config, cell.params, cell.device)
    k = cell.params["chunk_pairs"]
    n_chunks = cell.params["period"] // k
    call = entry(cell, frames)
    if cell.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(cell.device)
    out = call(0, None)  # warm-up: the one shape the window uses
    del out
    sync()
    setup_end = time.time()
    n, w, first = 0, None, None
    t0 = time.perf_counter()
    while True:
        w0 = w
        out = call(n % n_chunks, w0)
        w = out["w_final"]
        if n == 0:
            first = out
        n += 1
        if time.perf_counter() - t0 >= cell.seconds:
            break
    sync()
    elapsed = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(cell.device)
            if cell.device.type == "cuda" else 0)
    trace, traced_pairs = None, 0
    if cell.trace:
        calls = cell.params["trace_calls"]
        with traced(cell.scratch / f"{cell.name}.trace.json", with_stack=True) as got:
            for _ in range(calls):
                w0 = w
                out = call(n % n_chunks, w0)
                w = out["w_final"]
                n += 1
        trace, traced_pairs = got[0], calls * k
    c_last = (n - 1) % n_chunks
    checks = check_call(cell, frames[0 : k + 1], None, first)
    del first
    common.merge_worst(checks, check_call(cell, frames[c_last * k : c_last * k + k + 1], w0,
                                          out))
    pairs = (n - (cell.params["trace_calls"] if cell.trace else 0)) * k
    return {
        "setup_end": setup_end,
        "metrics": {"pairs_per_s": pairs / elapsed, "peak_mem_gib": peak / common.GIB},
        "memory_peak_bytes": peak,
        "attempted": pairs,
        "failed": 0,
        "checks": checks,
        "trace": trace,
        "traced_pairs": traced_pairs,
        "host": {"pairs_per_s": pairs / elapsed},
    }


def control(cell) -> dict:
    """The reference one precision lower (bfloat16) in the program's
    place on the stream's first chunk: the compression and the scan in
    bfloat16, then the segmentation with bfloat16 arithmetic on those maps,
    compared as :func:`run` compares the program."""
    import torch

    s = cell.params["sim"]
    k = cell.params["chunk_pairs"]
    frames = inputs.sequence(cell.seed, cell.config, cell.params, cell.device)
    chunk = frames[: k + 1]
    comp = ref_sim.compress(chunk, s["m"], s["n"], torch.bfloat16).cpu()
    w0 = torch.full(comp.shape[1:], ref_sim.DEVICE["w_init"], dtype=torch.bfloat16)
    w, gray = ref_sim.scan(comp, s, w0, xp=torch)
    mem_gray = gray.float().floor().to(torch.uint8).to(cell.device)
    seg = ref_seg.seg_step(mem_gray, chunk[:-1], chunk[1:], cell.config, torch.bfloat16)
    out = {"masks": seg["mask"], "flow": seg["flow"], "boxes": seg["box"],
           "any_active": seg["any_active"], "mem_gray": mem_gray, "w_final": w.float()}
    return check_call(cell, chunk, None, out)
