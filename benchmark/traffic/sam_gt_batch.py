"""Closed loop of device-resident batches of frames and box prompts through
the port's ground-truth mask step: ``sam_gt_batch`` with SAM.

Set-up builds SAM of the configuration's ``model`` block from weights drawn
on the device from the seed in the published checkpoint's layout
(``benchmark.reference.sam.synthetic_state``), loaded through the port's
``pretrained_sam`` (``load_state_dict(strict=True)``), the path a published
checkpoint takes; sets the precision the configuration states (cuDNN TF32
convolutions, float32 matrix products); draws ``params["batches"]`` batches
of ``params["batch"]`` RGB frames with their box prompts onto the device
(:func:`gt_frames`) and runs each once.  The window then calls the step on
them in turn, with no host synchronisation between calls, until
``--seconds`` have passed, and ends in one synchronisation.  With
``--trace 1`` ``params["trace_calls"]`` more calls run under the profiler.
``counters`` holds the kernel wrappers' launches and the step's frames and
boxes a call in the window (``_build.LAUNCHES``, ``_build.COUNTS``).
``pairs_per_s`` counts frames: one ground-truth mask a frame.

The check takes every frame of the last call and compares it with the
reference (``benchmark.reference.sam.sam_gt``, float32) on the same frames,
boxes and weights in blocks of ``params["check_block"]`` frames:

- ``logit_rel``: the largest |Δ| of the low-res logits over the
  reference's largest magnitude;
- ``iou_abs``: the largest gap of the IoU scores;
- ``mask_px``: the most mask pixels that differ in one frame;
- ``trivial_frames``: frames with a box whose reference mask is empty or
  covers the whole frame.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmark import common, inputs
from benchmark.reference import sam as ref_sam
from benchmark.trace import traced


def sam_config(cell):
    """The port's ``SamConfig`` of the configuration's ``model`` block; the
    parts the port does not make configurable must be the published ones."""
    from nsof_tpu_torch.models.sam import SamConfig

    m = cell.config["model"]
    fixed = (m["mlp_ratio"], m["qkv_bias"], m["use_rel_pos"], m["iou_head_depth"],
             m["iou_head_hidden_dim"], m["multimask_output"])
    if fixed != (4, True, True, 3, 256, False):
        raise ValueError(f"the port's SAM runs MLP ratio 4, qkv bias, the relative positions, "
                         f"a 3x256 IoU head and one mask a box, not {m}")
    return SamConfig(embed_dim=m["encoder_embed_dim"], depth=m["encoder_depth"],
                     num_heads=m["encoder_num_heads"],
                     global_attn_indexes=tuple(m["encoder_global_attn_indexes"]),
                     img_size=m["image_size"], patch_size=m["vit_patch_size"],
                     window_size=m["window_size"], prompt_dim=m["prompt_embed_dim"],
                     mask_in_chans=m["mask_in_chans"],
                     num_multimask_outputs=m["num_multimask_outputs"],
                     decoder_depth=m["decoder_depth"], decoder_heads=m["decoder_num_heads"],
                     decoder_mlp_dim=m["decoder_mlp_dim"])


def gt_frames(seed: int, cfg: dict, p: dict, device, salt: int = 0):
    """A batch from ``seed``: ``params["batch"]`` RGB frames ``[B, H, W, 3]``
    uint8, each a textured background with as many textured objects as it
    has boxes (``params["boxes_per_frame"]``, a fixed multiset in a seeded
    order, so every seed gives the same work); each box, float32 xyxy in
    frame pixels, is its object's rectangle (sides in
    ``params["object_px"]``) grown by a margin in ``params["margin_px"]`` a
    side and clipped to the frame; ``box_frame`` int64, sorted.  ``salt``
    tells apart the batches a cell keeps."""
    rng = inputs._rng(seed, 0x5A40 + salt)
    n, h, w = p["batch"], cfg["image_h"], cfg["image_w"]
    counts = rng.permutation(np.asarray(p["boxes_per_frame"][:n]))
    slots = int(counts.max(initial=0))
    lo, hi = p["object_px"]
    oh = rng.integers(lo, hi + 1, (n, slots))
    ow = rng.integers(lo, hi + 1, (n, slots))
    y0 = (rng.random((n, slots)) * (h - oh + 1)).astype(np.int64)
    x0 = (rng.random((n, slots)) * (w - ow + 1)).astype(np.int64)
    margin = rng.integers(p["margin_px"][0], p["margin_px"][1] + 1, (n, slots, 4))
    bg, ob = inputs._waves(rng, 3 * n, p), inputs._waves(rng, 3 * n * slots, p)

    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)  # noqa: E731
    y = torch.arange(h, dtype=torch.float64, device=device)[None, :]
    x = torch.arange(w, dtype=torch.float64, device=device)[None, :]
    frames = torch.empty((n, 3, h, w), dtype=torch.uint8, device=device)
    step = max(1, inputs._chunk(h, w) // 3)
    for s in range(0, n, step):
        e = min(s + step, n)
        c = 3 * (e - s)
        img = inputs._render(t(bg[3 * s : 3 * e]), y.expand(c, h), x.expand(c, w))
        for j in range(slots):
            here = np.repeat(counts[s:e] > j, 3)
            rows = np.repeat(np.stack([y0[s:e, j], y0[s:e, j] + oh[s:e, j]], 1), 3, axis=0)
            cols = np.repeat(np.stack([x0[s:e, j], x0[s:e, j] + ow[s:e, j]], 1), 3, axis=0)
            rows[~here] = 0  # no object j in this frame: an empty rectangle
            r, q = t(rows)[:, :, None], t(cols)[:, :, None]
            inside = (((y >= r[:, 0]) & (y < r[:, 1]))[:, :, None]
                      & ((x >= q[:, 0]) & (x < q[:, 1]))[:, None, :])
            waves = ob.reshape(n, slots, 3, *ob.shape[1:])[s:e, j].reshape(c, *ob.shape[1:])
            img = torch.where(inside, inputs._render(t(waves), y.expand(c, h), x.expand(c, w)),
                              img)
        frames[s:e] = inputs._u8(img).view(e - s, 3, h, w)
    boxes, owner = [], []
    for f in range(n):
        for j in range(counts[f]):
            m = margin[f, j]
            boxes.append([max(x0[f, j] - m[0], 0), max(y0[f, j] - m[1], 0),
                          min(x0[f, j] + ow[f, j] + m[2], w), min(y0[f, j] + oh[f, j] + m[3], h)])
            owner.append(f)
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    return (frames.permute(0, 2, 3, 1).contiguous(), torch.from_numpy(boxes).to(device),
            torch.as_tensor(owner, dtype=torch.int64, device=device))


def make_batches(cell):
    return [gt_frames(cell.seed, cell.config, cell.params, cell.device, salt=i)
            for i in range(cell.params["batches"])]


def entry(cell):
    """The timed call: ``sam_gt_batch`` on one batch ``(frames, boxes,
    box_frame)``, SAM from the seed's weights on the cell's device."""
    from nsof_tpu_torch.data.gt_tooling import sam_gt_batch
    from nsof_tpu_torch.models.sam import pretrained_sam

    state = ref_sam.synthetic_state(cell.seed, cell.config["model"], cell.device)
    model = pretrained_sam(state, sam_config(cell), cell.device).eval().requires_grad_(False)
    del state  # the model holds these tensors; the check draws them anew

    def call(batch):
        return sam_gt_batch(model, *batch)
    return call


def check(cell, batch, out, dt=None) -> dict:
    """Every frame of ``out`` against the reference on ``batch``, in blocks
    of frames; the worst of each number over the blocks.  With ``dt`` the
    reference in that arithmetic stands in for ``out``."""
    model = cell.config["model"]
    state = ref_sam.synthetic_state(cell.seed, model, cell.device)
    frames, boxes, owner = batch
    blk = cell.params["check_block"]
    gap = top = iou_gap = mask_px = trivial = 0.0
    shares = []
    for s in range(0, frames.shape[0], blk):
        idx = torch.nonzero((owner >= s) & (owner < s + blk))[:, 0]
        rows = (frames[s : s + blk], boxes[idx], owner[idx] - s)
        want = ref_sam.sam_gt(*rows, model, state)
        got = ({"mask": out["mask"][s : s + blk], "low_res": out["low_res"][idx],
                "iou": out["iou"][idx]} if dt is None
               else ref_sam.sam_gt(*rows, model, state, dt))
        if len(idx):
            d = (got["low_res"].float() - want["low_res"]).abs().max()
            gap = max(gap, float(d) if bool(torch.isfinite(d)) else float("inf"))
            top = max(top, float(want["low_res"].abs().max()))
            d = (got["iou"].float() - want["iou"]).abs().max()
            iou_gap = max(iou_gap, float(d) if bool(torch.isfinite(d)) else float("inf"))
        mask_px = max(mask_px, float((got["mask"] != want["mask"]).flatten(1).sum(dim=1).max()))
        has = torch.bincount(owner[idx] - s, minlength=want["mask"].shape[0]) > 0
        share = want["mask"].flatten(1).float().mean(dim=1)
        trivial += float((((share == 0) | (share == 1)) & has).sum())
        shares += share[has].tolist()
        del want, got
    print(f"sam_gt_batch: the reference's masks cover {min(shares, default=0):.3f}-"
          f"{max(shares, default=0):.3f} of their frames; its largest low-res logit {top:.4g}",
          file=sys.stderr)
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()
    return {"logit_rel": gap / top if top else float("inf"), "iou_abs": iou_gap,
            "mask_px": mask_px, "trivial_frames": trivial}


def run(cell) -> dict:
    from nsof_tpu_torch import _build

    sam_config(cell)  # a port without this configuration's options fails here, at once
    sync = torch.cuda.synchronize if cell.device.type == "cuda" else (lambda: None)
    # the configuration's precision, PyTorch's defaults set explicitly: TF32
    # convolutions in cuDNN, float32 matrix products in cuBLAS
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    call = entry(cell)
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
    counters = {name: v / n for c in (_build.LAUNCHES, _build.COUNTS)
                for name, v in c.items() if v}
    peak = (torch.cuda.max_memory_allocated(cell.device)
            if cell.device.type == "cuda" else 0)
    last = (n - 1) % k
    frames = n * cell.params["batch"]
    trace, traced_frames = None, 0
    if cell.trace:
        calls = cell.params["trace_calls"]
        with traced(cell.scratch / f"{cell.name}.trace.json", with_stack=True) as got:
            for j in range(calls):
                out = call(batches[(n + j) % k])
        trace, last = got[0], (n + calls - 1) % k
        traced_frames = calls * cell.params["batch"]
    batch = batches[last]
    del batches, call
    checks = check(cell, batch, out)
    return {
        "setup_end": setup_end,
        "metrics": {"pairs_per_s": frames / elapsed, "peak_mem_gib": peak / common.GIB},
        "memory_peak_bytes": peak,
        "attempted": frames,
        "failed": 0,
        "checks": checks,
        "trace": trace,
        "traced_pairs": traced_frames,
        "host": {"pairs_per_s": frames / elapsed},
        "counters": counters,
    }


def control(cell) -> dict:
    """The reference one precision lower (the encoder and the decoder under
    bfloat16 autocast) in the program's place, on the cell's first batch,
    compared as :func:`run` compares the program."""
    batch = gt_frames(cell.seed, cell.config, cell.params, cell.device, salt=0)
    return check(cell, batch, None, dt=torch.bfloat16)
