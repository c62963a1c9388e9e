"""Closed loop of device-resident batches through ``seg_batch_fast``.

Set-up draws ``params["batches"]`` batches of ``params["batch"]`` frame
pairs from the seed (``benchmark.inputs.pairs``) onto the device and runs
each once.  The window then calls ``seg_batch_fast(..., return_flow=True)``
on them in turn, with no host synchronisation between calls, until
``--seconds`` have passed on the host clock, and ends in one
synchronisation: ``pairs_per_s`` is every pair of every call over the whole
window.  With ``--trace 1`` a few more calls run under the profiler.

The check takes the last call's output, every row of it, once the window
has closed and the other batches are freed, and compares it with the
reference run on the same inputs in blocks of ``params["check_block"]``
rows.
"""

from __future__ import annotations

import time

from benchmark import common, inputs
from benchmark.reference import segmentation as ref_seg
from benchmark.trace import traced

OUT_KEYS = ("mask", "flow", "box", "any_active")


def make_batches(cell):
    p = cell.params
    return [inputs.pairs(cell.seed, cell.config, p, p["batch"], cell.device, salt=i)
            for i in range(p["batches"])]


def entry(cell):
    """The timed call: ``seg_batch_fast`` on one batch ``(mem, prev, nxt)``."""
    from nsof_tpu_torch.pipelines import segmentation

    cfg = cell.pipeline_config()
    mode = cell.config["kernel_mode"]

    def call(batch):
        return segmentation.seg_batch_fast(*batch, cfg, kernel_mode=mode, return_flow=True,
                                           device=cell.device)
    return call


def check(cell, batch, out, dt=None) -> dict:
    """Every row of ``out`` against the reference on ``batch``, in blocks;
    the worst of each number over the blocks."""
    import torch

    blk = cell.params["check_block"]
    checks = {}
    for s in range(0, batch[0].shape[0], blk):
        rows = [x[s : s + blk] for x in batch]
        want = ref_seg.seg_step(*rows, cell.config)
        got = ({k: out[k][s : s + blk] for k in OUT_KEYS} if dt is None
               else ref_seg.seg_step(*rows, cell.config, dt))
        common.merge_worst(checks, common.seg_checks(got, want))
        del want, got
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()
    return checks


def run(cell) -> dict:
    import torch

    sync = torch.cuda.synchronize if cell.device.type == "cuda" else (lambda: None)
    batches = make_batches(cell)
    call = entry(cell)
    if cell.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(cell.device)
    for b in batches:  # warm-up: every shape the window uses
        out = call(b)
    del out
    sync()
    setup_end = time.time()
    k, n, out = len(batches), 0, None
    t0 = time.perf_counter()
    while True:
        out = call(batches[n % k])
        n += 1
        if time.perf_counter() - t0 >= cell.seconds:
            break
    sync()
    elapsed = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(cell.device)
            if cell.device.type == "cuda" else 0)
    last = (n - 1) % k
    pairs = n * cell.params["batch"]
    trace, traced_pairs = None, 0
    if cell.trace:
        calls = cell.params["trace_calls"]
        with traced(cell.scratch / f"{cell.name}.trace.json", with_stack=True) as got:
            for j in range(calls):
                out = call(batches[(n + j) % k])
        trace, last = got[0], (n + calls - 1) % k
        traced_pairs = calls * cell.params["batch"]
    batch = batches[last]
    del batches
    checks = check(cell, batch, out)
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
    """The reference one precision lower (bfloat16 arithmetic) in the
    program's place, on the cell's first batch, compared as :func:`run`
    compares the program."""
    import torch

    batch = inputs.pairs(cell.seed, cell.config, cell.params, cell.params["batch"],
                         cell.device, salt=0)
    return check(cell, batch, None, dt=torch.bfloat16)
