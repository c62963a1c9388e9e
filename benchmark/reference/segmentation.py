"""The ROI-gated segmentation step, as the benchmark's reference.

Per frame pair: the state map's active cells (value >= THRES) give the
merged ROI box (their bounding box in image pixels, EXTEND-padded and
clamped; an all-zero box when no cell is active); a fixed window is cut at
the box's top-left, clamped into the frame; the flow is computed on the
window (``farneback.flow``); the head thresholds |flow|² at SEG_TH², keeps
it inside the box and smooths it with N × (dilate, erode) under OpenCV's
ellipse, re-masked to the box between steps; mask and negated flow are
written back into the frame inside the box.

The gate and the morphology are written afresh here (the morphology as a
plain OR over the structuring element's offsets), not copied from the
port; the flow is ``farneback``'s frozen copy.  ``cfg`` is the
configuration file's dict (``benchmark/configs/<name>.json``).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import farneback


def ellipse_se(rows: int, cols: int) -> np.ndarray:
    """``cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (cols, rows))``."""
    r, c = rows // 2, cols // 2
    inv_r2 = 1.0 / (r * r) if r > 0 else 0.0
    se = np.zeros((rows, cols), np.uint8)
    for i in range(rows):
        dy = i - r
        if abs(dy) <= r:
            dx = int(round(c * np.sqrt(max(r * r - dy * dy, 0) * inv_r2)))
            se[i, max(c - dx, 0) : min(c + dx + 1, cols)] = 1
    return se


def dilate(x: torch.Tensor, se: np.ndarray) -> torch.Tensor:
    """out(y, x) = OR over the SE's offsets (dy, dx) of in(y + dy, x + dx),
    offsets relative to the anchor (rows//2, cols//2); False outside."""
    kh, kw = se.shape
    ay, ax = kh // 2, kw // 2
    h, w = x.shape[-2:]
    pad = max(kh, kw)
    xp = torch.nn.functional.pad(x, (pad, pad, pad, pad))
    out = torch.zeros_like(x)
    for i, j in zip(*np.nonzero(se)):
        dy, dx = int(i) - ay, int(j) - ax
        out |= xp[..., pad + dy : pad + dy + h, pad + dx : pad + dx + w]
    return out


def head(mag2: torch.Tensor, inbox: torch.Tensor, cfg: dict) -> torch.Tensor:
    """The seg head on |flow|² ``[B, h, w]`` → bool mask."""
    hd = cfg["head"]
    se = ellipse_se(hd["morph_ksize"], hd["morph_ksize"])
    x = (mag2 > hd["seg_th"] ** 2) & inbox
    for _ in range(hd["morph_iters"]):
        x = dilate(x & inbox, se)
        x = ~dilate(~x & inbox, se)  # erosion, with outside the box set
    return x & inbox


def gate(mem: torch.Tensor, cfg: dict):
    """``[B, gh, gw]`` uint8 state maps → merged box ``[B, 4]`` int32
    (x0, y0, x1, y1, end exclusive) and ``any_active`` ``[B]``."""
    roi = cfg["roi"]
    h, w, px = cfg["image_h"], cfg["image_w"], roi["memsize"]
    act = mem >= roi["thres"]
    any_active = act.flatten(1).any(dim=1)
    rows = act.any(dim=2)  # [B, gh]
    cols = act.any(dim=1)  # [B, gw]

    def first_last(v):
        idx = torch.arange(v.shape[1], device=v.device)
        lo = torch.where(v, idx, v.shape[1]).amin(dim=1)
        hi = torch.where(v, idx + 1, 0).amax(dim=1)
        return lo, hi

    r0, r1 = first_last(rows)
    c0, c1 = first_last(cols)
    box = torch.stack([
        (c0 * px - roi["extend_left"]).clamp(min=0),
        (r0 * px - roi["extend_up"]).clamp(min=0),
        (c1 * px + roi["extend_right"]).clamp(max=w),
        (r1 * px + roi["extend_down"]).clamp(max=h),
    ], dim=1)
    box = torch.where(any_active[:, None], box, torch.zeros_like(box))
    return box.to(torch.int32), any_active


def seg_step(mem, prev, nxt, cfg: dict, dt=torch.float32) -> dict:
    """The step on a batch: ``mem`` ``[B, gh, gw]`` uint8, ``prev``/``nxt``
    ``[B, H, W]`` uint8 → ``mask`` [B, H, W] uint8 {0, 255}, ``flow``
    [B, H, W, 2] float32 (negated, zero outside the box), ``box``,
    ``any_active``.  ``dt`` is the flow's arithmetic (the control's is
    lower)."""
    h, w = cfg["image_h"], cfg["image_w"]
    wh, ww = cfg["window_h"] or h, cfg["window_w"] or w
    b = mem.shape[0]
    box, active = gate(mem, cfg)
    oy = box[:, 1].long().clamp(0, max(h - wh, 0))
    ox = box[:, 0].long().clamp(0, max(w - ww, 0))
    dev = prev.device
    ys = oy[:, None, None] + torch.arange(wh, device=dev)[None, :, None]
    xs = ox[:, None, None] + torch.arange(ww, device=dev)[None, None, :]
    bi = torch.arange(b, device=dev)[:, None, None]
    dx, dy = farneback.flow(prev[bi, ys, xs], nxt[bi, ys, xs], cfg["fb"],
                            cfg["warp_radius"], dt)
    bx = box.long()
    inbox = ((ys >= bx[:, 1, None, None]) & (ys < bx[:, 3, None, None])
             & (xs >= bx[:, 0, None, None]) & (xs < bx[:, 2, None, None])
             & active[:, None, None])
    m = head(dx * dx + dy * dy, inbox, cfg)
    mask = torch.zeros((b, h, w), dtype=torch.uint8, device=dev)
    mask[bi, ys, xs] = torch.where(inbox, m.to(torch.uint8) * 255, 0).to(torch.uint8)
    fl = torch.zeros((b, h, w, 2), dtype=torch.float32, device=dev)
    win = torch.stack([-dx, -dy], dim=-1).float()
    fl[bi, ys, xs] = torch.where(inbox[..., None], win, 0.0)
    return {"mask": mask, "flow": fl, "box": box, "any_active": active}
