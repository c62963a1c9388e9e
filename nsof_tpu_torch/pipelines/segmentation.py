"""ROI-gated motion segmentation, batched: the port's main path.

Counterpart of the throughput path of :mod:`nsof_tpu.pipelines.segmentation`
(``seg_batch_fast`` and its head).  Per frame pair the device-state map
gates the merged (FLAG=2) ROI; a static-size window is cropped at the ROI's
origin (K1); the fast Farnebäck computes flow on the window (the fused
route, K2–K4, or for presets beyond its halos the level route, K5 and K6);
the head thresholds |flow|² and smooths it with N × (dilate ∘
erode) under the ellipse, re-masking to the box between steps to emulate
the reference's morphology on the cropped region; and the mask is
scattered back into the frame.
"""

from __future__ import annotations

import torch

from nsof_tpu_torch import _build
from nsof_tpu_torch.config import PipelineConfig
from nsof_tpu_torch.ops import roi as roi_ops
from nsof_tpu_torch.ops.farneback_fast import farneback_fast
from nsof_tpu_torch.ops.morphology import ellipse_se
from nsof_tpu_torch.ops.morphology_fast import dilate_erode_n_masked


def _seg_head_mag2(mag2: torch.Tensor, inbox: torch.Tensor,
                   cfg: PipelineConfig) -> torch.Tensor:
    """Seg head on |flow|² ``[B, h, w]`` → ``[B, h, w]`` uint8 {0, 255}
    (the JAX package's ``_seg_head_mag2_hwb``, batch first)."""
    x = (mag2 > cfg.head.seg_th**2) & inbox
    se = ellipse_se(cfg.head.morph_ksize, cfg.head.morph_ksize)
    x = dilate_erode_n_masked(x, inbox, se, cfg.head.morph_iters)
    return x.to(torch.uint8) * 255


def seg_head_window_batch(flow_win: torch.Tensor, inbox: torch.Tensor,
                          cfg: PipelineConfig) -> torch.Tensor:
    """Batched seg head: ``[B, h, w, 2]`` flow + ``[B, h, w]`` box mask →
    ``[B, h, w]`` uint8 {0, 255}."""
    fx, fy = flow_win[..., 0], flow_win[..., 1]
    mag2 = fx * fx + fy * fy
    return _seg_head_mag2(mag2, inbox.bool(), cfg)


def seg_batch_fast(
    mem_u8,
    prev_gray,
    next_gray,
    cfg: PipelineConfig,
    warp_radius: int | None = None,
    kernel_mode: str = "auto",
    return_flow: bool = False,
    device=None,
) -> dict:
    """Throughput path: batched ROI gating + the fast Farnebäck.

    ``mem_u8`` ``[B, gh, gw]`` uint8 device-state maps, ``prev_gray`` /
    ``next_gray`` ``[B, H, W]`` uint8 frames (tensors or numpy arrays).
    Returns ``mask`` [B, H, W] uint8, ``box`` [B, 4] int32, ``any_active``
    [B], ``region_pct`` [B] and, with ``return_flow``, ``flow``
    [B, H, W, 2] (negated, zero outside the ROI).

    Runs on ``device``; by default the CUDA device, and it raises
    ``RuntimeError`` when there is none (``device='cpu'`` runs the plain
    versions).  ``warp_radius=None`` takes ``cfg.warp_radius``;
    ``kernel_mode`` picks the Farnebäck route (see
    :func:`nsof_tpu_torch.ops.farneback_fast.farneback_fast`).
    """
    dev = _build.resolve_device(device)
    if warp_radius is None:
        warp_radius = cfg.warp_radius
    h, w = cfg.image_h, cfg.image_w
    wh, ww = cfg.win_shape
    mem = torch.as_tensor(mem_u8).to(dev)
    prev = torch.as_tensor(prev_gray).to(dev).contiguous()
    nxt = torch.as_tensor(next_gray).to(dev).contiguous()

    r = roi_ops.roi_boxes(mem, h, w, cfg.roi)
    box = r["merged"]
    active = r["any_active"]
    oys, oxs = roi_ops.window_origin(box, wh, ww, h, w)
    p_win = roi_ops.crop_windows_batch(prev, oys, oxs, wh, ww)
    n_win = roi_ops.crop_windows_batch(nxt, oys, oxs, wh, ww)

    # the head needs only |flow|², so the Farnebäck sign flip is skipped
    dx, dy = farneback_fast(p_win, n_win, cfg.fb, warp_radius, kernel_mode,
                            out_layout="planes", device=dev)
    inbox = roi_ops.window_box_mask(box, oys, oxs, wh, ww) & active[:, None, None]
    mask_win = _seg_head_mag2(dx * dx + dy * dy, inbox, cfg)
    b = mem.shape[0]
    mask = roi_ops.scatter_window(
        torch.zeros((b, h, w), dtype=torch.uint8, device=dev), mask_win, box,
        oys, oxs,
    )
    out = {
        "mask": mask,
        "box": box,
        "any_active": active,
        "region_pct": roi_ops.region_percentage(box, h, w),
    }
    if return_flow:
        # negated (optical_flow_seg.py:461), zero outside the box
        flow_win = torch.stack([-dx, -dy], dim=-1)
        flow_win = torch.where(inbox[..., None], flow_win, torch.zeros_like(flow_win))
        out["flow"] = roi_ops.scatter_window(
            torch.zeros((b, h, w, 2), dtype=torch.float32, device=dev),
            flow_win, box, oys, oxs,
        )
    return out


def pixel_accuracy(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """calculate_pixel_accuracy (optical_flow_seg.py:384-388): % of equal
    pixels."""
    return 100.0 * (pred == gt).to(torch.float32).mean()
