"""Closed loop of device-resident batches of RGB pairs through the port's
deep ROI step: ``deep_roi_flow_batch`` on a ``DeepBackend`` (RAFT).

Set-up builds the model of the configuration's ``model`` block from weights
drawn from the seed in the published checkpoint's layout
(``benchmark.reference.raft.synthetic_state``), loaded through the port's
``load_raft_state``, the path a published checkpoint takes; sets the
precision the configuration states (cuDNN TF32 convolutions, float32
matrix products); draws ``params["batches"]`` batches of
``params["batch"]`` RGB pairs from the seed (:func:`rgb_pairs`) onto the
device and runs each once.  The window then calls the step on them in
turn, with no host synchronisation between calls, until ``--seconds``
have passed, and ends in one synchronisation.  With ``--trace 1`` a few
more calls run under the profiler.  ``counters`` holds the kernel
wrappers' launches a call in the window (``_build.LAUNCHES``).

The check takes the last call's output, every row of it, and compares it
with the reference (``benchmark.reference.raft.roi_step``, float32) on the
same inputs and weights in blocks of ``params["check_block"]`` rows.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmark import common, inputs
from benchmark.reference import raft as ref_raft
from benchmark.trace import traced

OUT_KEYS = ("mask", "flow", "box", "any_active")


def rgb_pairs(seed: int, cfg: dict, p: dict, n: int, device, salt: int = 0):
    """``n`` RGB frame pairs from ``seed`` (:func:`benchmark.inputs.pairs`
    with three independent textures a frame): ``mem`` ``[n, gh, gw]`` on
    the MEMSIZE/3 grid, ``prev`` and ``nxt`` ``[n, H, W, 3]``, uint8 on
    ``device``."""
    rng = inputs._rng(seed, 1 + salt)
    h, w = cfg["image_h"], cfg["image_w"]
    ms, thres = max(cfg["roi"]["memsize"] // 3, 1), cfg["roi"]["thres"]
    gh, gw = h // ms, w // ms
    shapes = [(bh, bw) for bh in range(p["block_rows"][0], p["block_rows"][1] + 1)
              for bw in range(p["block_cols"][0], p["block_cols"][1] + 1)]
    order = rng.permutation(n)
    bh = np.array([shapes[i % len(shapes)][0] for i in order])
    bw = np.array([shapes[i % len(shapes)][1] for i in order])
    active = np.array([i % p["inactive_every"] != 0 for i in order])
    r0 = rng.integers(0, gh - bh + 1)
    c0 = rng.integers(0, gw - bw + 1)
    shift = rng.uniform(-p["shift_px"], p["shift_px"], (n, 2))
    mem = rng.integers(0, thres, (n, gh, gw))
    hot = rng.integers(thres, 256, (n, gh, gw))
    cells_y, cells_x = np.indices((gh, gw))
    block = ((cells_y >= r0[:, None, None]) & (cells_y < (r0 + bh)[:, None, None])
             & (cells_x >= c0[:, None, None]) & (cells_x < (c0 + bw)[:, None, None]))
    mem = np.where(block & active[:, None, None], hot, mem).astype(np.uint8)
    m = p["object_margin_px"]
    rect = np.stack([r0 * ms + m, (r0 + bh) * ms - m, c0 * ms + m, (c0 + bw) * ms - m], 1)
    bg, ob = inputs._waves(rng, 3 * n, p), inputs._waves(rng, 3 * n, p)  # 3 channels a sample

    prev = torch.empty((n, 3, h, w), dtype=torch.uint8, device=device)
    nxt = torch.empty_like(prev)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)  # noqa: E731
    y = torch.arange(h, dtype=torch.float64, device=device)[None, :]
    x = torch.arange(w, dtype=torch.float64, device=device)[None, :]
    step = max(1, inputs._chunk(h, w) // 3)
    for s in range(0, n, step):
        e = min(s + step, n)
        c = 3 * (e - s)
        rc = t(np.repeat(rect[s:e], 3, axis=0))[:, :, None]
        sy, sx = (t(np.repeat(shift[s:e, i], 3))[:, None] for i in (0, 1))
        back = inputs._render(t(bg[3 * s : 3 * e]), y.expand(c, h), x.expand(c, w))
        for out, dy, dx in ((prev, 0.0, 0.0), (nxt, sy, sx)):
            yy, xx = (y - dy).expand(c, h), (x - dx).expand(c, w)
            inside = (((yy >= rc[:, 0]) & (yy < rc[:, 1]))[:, :, None]
                      & ((xx >= rc[:, 2]) & (xx < rc[:, 3]))[:, None, :])
            img = torch.where(inside, inputs._render(t(ob[3 * s : 3 * e]), yy, xx), back)
            out[s:e] = inputs._u8(img).view(e - s, 3, h, w)
    return (torch.as_tensor(mem, device=device), prev.permute(0, 2, 3, 1).contiguous(),
            nxt.permute(0, 2, 3, 1).contiguous())


def make_batches(cell):
    p = cell.params
    return [rgb_pairs(cell.seed, cell.config, p, p["batch"], cell.device, salt=i)
            for i in range(p["batches"])]


def raft_config(cell):
    """The port's ``RaftConfig`` of the configuration's ``model`` block."""
    from nsof_tpu_torch.models.raft import RaftConfig

    m = cell.config["model"]
    cfg = RaftConfig(small=m["small"], corr_levels=m["corr_levels"],
                     corr_radius=m["corr_radius"], iters=m["iters"], corr_mode=m["corr_mode"],
                     cnet_norm=m["cnet_norm"], corr_pool=m["corr_pool"])
    if (cfg.hidden_dim, cfg.context_dim) != (m["hidden_dim"], m["context_dim"]):
        raise ValueError(f"RaftConfig(small={m['small']}) has other widths than {m}")
    return cfg


def entry(cell, state):
    """The timed call: ``deep_roi_flow_batch`` on one batch ``(mem, prev,
    nxt)``, RAFT from ``state`` bound to the cell's device."""
    from nsof_tpu_torch.models.convert import load_raft_state
    from nsof_tpu_torch.models.raft import RAFT
    from nsof_tpu_torch.pipelines.deep_flow import DeepBackend, deep_roi_flow_batch

    model = load_raft_state(RAFT(raft_config(cell)), state)
    backend = DeepBackend.from_raft(model, iters=cell.config["model"]["iters"],
                                    device=cell.device)
    cfg = cell.pipeline_config()

    def call(batch):
        return deep_roi_flow_batch(*batch, cfg, backend)
    return call


def check(cell, batch, out, state, dt=None) -> dict:
    """Every row of ``out`` against the reference on ``batch``, in blocks;
    the worst of each number over the blocks.  With ``dt`` the reference
    in that arithmetic stands in for ``out``."""
    blk = cell.params["check_block"]
    st = {k: v.to(cell.device) for k, v in state.items()}
    checks, active, masked = {}, 0, 0
    for s in range(0, batch[0].shape[0], blk):
        rows = [x[s : s + blk] for x in batch]
        want = ref_raft.roi_step(*rows, cell.config, st)
        got = ({k: out[k][s : s + blk] for k in OUT_KEYS} if dt is None
               else ref_raft.roi_step(*rows, cell.config, st, dt))
        common.merge_worst(checks, common.seg_checks(got, want))
        active += int(want["any_active"].sum())
        masked += int((want["mask"].flatten(1).any(dim=1) & want["any_active"]).sum())
        del want, got
    print(f"deep_batch: {masked} of the reference's {active} active rows have a non-empty "
          "mask", file=sys.stderr)
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()
    return checks


def run(cell) -> dict:
    from nsof_tpu_torch import _build

    raft_config(cell)  # a port without this configuration's options fails here, at once
    sync = torch.cuda.synchronize if cell.device.type == "cuda" else (lambda: None)
    # the configuration's precision, PyTorch's defaults set explicitly: TF32
    # convolutions in cuDNN, float32 matrix products in cuBLAS
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    state = ref_raft.synthetic_state(cell.seed, cell.config["model"])
    call = entry(cell, state)
    batches = make_batches(cell)
    if cell.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(cell.device)
    for b in batches:  # warm-up: every shape the window uses
        out = call(b)
    del out
    sync()
    setup_end = time.time()
    _build.reset_launches()
    k, n, out = len(batches), 0, None
    t0 = time.perf_counter()
    while True:
        out = call(batches[n % k])
        n += 1
        if time.perf_counter() - t0 >= cell.seconds:
            break
    sync()
    elapsed = time.perf_counter() - t0
    counters = {name: v / n for name, v in _build.LAUNCHES.items() if v}
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
    checks = check(cell, batch, out, state)
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
        "counters": counters,
    }


def control(cell) -> dict:
    """The reference one precision lower (bfloat16 autocast over the
    encoders and the update block) in the program's place, on the cell's
    first batch, compared as :func:`run` compares the program."""
    batch = rgb_pairs(cell.seed, cell.config, cell.params, cell.params["batch"], cell.device,
                      salt=0)
    state = ref_raft.synthetic_state(cell.seed, cell.config["model"])
    return check(cell, batch, None, state, dt=torch.bfloat16)
