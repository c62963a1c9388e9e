"""Object tracking (``optical_flow_ob.py``), batched over B.

Counterpart of :mod:`nsof_tpu.pipelines.tracking`.  Head: flow polar →
the reference's HSV image → BGR → gray → grayscale MORPH_CLOSE (3×3
ellipse) → threshold at SEG_TH → connected components (8-connected) →
boxes of area ≥ 500 → NMS at IoU 0.2 scored by area
(process_flow_region_tracking, optical_flow_ob.py:321-379).  Boxes live in
``max_boxes`` static slots with a validity mask.

Entry points: :func:`tracking_batch_fast` (the throughput path: K1 crops
and the fast Farnebäck), :func:`tracking_step` and
:func:`tracking_step_full` (the exact path, no kernel) and
:func:`tracking_stages` (the dual-path replay stages).  The labelling of
the head is :func:`~nsof_tpu_torch.ops.components.label_components_sweep`,
which synchronises with the host once every 8 sweeps, so every tracking
call does (at most 32 times).

As in the JAX package, areas are pixel counts where the reference filters
by ``cv2.contourArea`` (the outer contour's polygon area, smaller by about
half the perimeter).
"""

from __future__ import annotations

import math

import torch

from nsof_tpu_torch import _build
from nsof_tpu_torch.config import PipelineConfig
from nsof_tpu_torch.ops import colorspace as cs
from nsof_tpu_torch.ops import components as comp
from nsof_tpu_torch.ops import morphology as morph
from nsof_tpu_torch.ops import roi as roi_ops
from nsof_tpu_torch.ops.farneback import farneback
from nsof_tpu_torch.pipelines.segmentation import (fast_window_flow, gate, roi_stages,
                                                   window_flow)

_F32_MAX = 3.4e38


def flow_gray_window(flow_win: torch.Tensor, inbox: torch.Tensor) -> torch.Tensor:
    """The reference's flow → gray chain on masked windows ``[B, h, w, 2]``
    (optical_flow_ob.py:333-341): hue from the angle, value the magnitude
    min-max normalised over each sample's box, HSV → BGR → gray, zero
    outside the box → uint8 ``[B, h, w]``."""
    mag, ang = cs.cart_to_polar(flow_win[..., 0], flow_win[..., 1])
    mn = torch.where(inbox, mag, _F32_MAX).amin(dim=(-2, -1), keepdim=True)
    mx = torch.where(inbox, mag, -_F32_MAX).amax(dim=(-2, -1), keepdim=True)
    scale = torch.where(mx - mn > 1e-12, cs.ratio(255.0, mx - mn), 0.0)
    val = (mag - mn) * scale
    hsv = torch.stack([cs.trunc_u8(ang * 180.0 / math.pi / 2.0),
                       torch.full_like(val, 255, dtype=torch.uint8),
                       cs.trunc_u8(val)], dim=-1)
    gray = cs.bgr_to_gray_u8(cs.hsv_to_bgr_u8(hsv))
    return torch.where(inbox, gray, 0).to(torch.uint8)


def tracking_head_window(flow_win: torch.Tensor, inbox: torch.Tensor, origin_yx,
                         cfg: PipelineConfig) -> dict:
    """Gray → close → threshold → components → area filter → NMS on
    windows ``[B, h, w, 2]`` whose top-left pixels sit at ``origin_yx``
    (``[B]`` rows, ``[B]`` columns).

    Returns ``boxes`` [B, max_boxes, 4] float32 (x1, y1, x2, y2) in image
    coordinates, ``valid`` [B, max_boxes] and ``areas`` [B, max_boxes]."""
    gray = flow_gray_window(flow_win, inbox)
    se = morph.ellipse_se(cfg.head.close_ksize, cfg.head.close_ksize)
    # grayscale MORPH_CLOSE with the box's border emulated: outside-box
    # pixels take each stage's border identity
    dil = morph.dilate_gray(torch.where(inbox, gray, 0), se)
    closed = morph.erode_gray(torch.where(inbox, dil, 255), se)
    binary = cs.threshold_binary(torch.where(inbox, closed, 0), cfg.head.seg_th)
    stats = comp.component_stats_scatter(comp.label_components_sweep(binary, 8),
                                 cfg.head.max_boxes)
    boxes = stats["boxes"].float()  # (x, y, w, h) in window coordinates
    areas = stats["areas"].float()
    valid = stats["valid"] & (areas >= cfg.head.min_box_area)
    oy = origin_yx[0].float()[:, None]
    ox = origin_yx[1].float()[:, None]
    x, y, w, h = boxes.unbind(-1)
    xyxy = torch.stack([x + ox, y + oy, x + w + ox, y + h + oy], dim=-1)
    keep = comp.nms(xyxy, areas, valid, cfg.head.nms_iou)
    return {"boxes": xyxy, "valid": keep & valid, "areas": areas}


def _tracking_out(head: dict, roi: dict) -> dict:
    head["valid"] = head["valid"] & roi["active"][:, None]
    head["box"] = roi["box"]
    head["any_active"] = roi["active"]
    return head


def tracking_batch_fast(mem_u8, prev_gray, next_gray, cfg: PipelineConfig,
                        warp_radius: int | None = None, kernel_mode: str = "auto",
                        device=None) -> dict:
    """Throughput tracking: the batched ROI gate, K1 crops, the fast
    Farnebäck in ``kernel_mode`` (as :func:`~nsof_tpu_torch.pipelines.
    segmentation.seg_batch_fast` runs it) and the head.

    ``[B, gh, gw]`` uint8 state maps and ``[B, H, W]`` uint8 frames →
    ``boxes`` [B, max_boxes, 4], ``valid``, ``areas``, ``box`` [B, 4] and
    ``any_active`` [B].  Runs on ``device`` (default the CUDA device; raises
    ``RuntimeError`` without one unless ``device='cpu'``)."""
    dev = _build.resolve_device(device)
    mem = torch.as_tensor(mem_u8).to(dev)
    prev = torch.as_tensor(prev_gray).to(dev).contiguous()
    nxt = torch.as_tensor(next_gray).to(dev).contiguous()
    roi = gate(mem, cfg)
    flow_win, inbox = fast_window_flow(
        prev, nxt, roi, cfg, cfg.warp_radius if warp_radius is None else warp_radius,
        kernel_mode)
    return _tracking_out(tracking_head_window(flow_win, inbox, roi["origin"], cfg), roi)


def tracking_step(mem_u8, prev_gray, next_gray, cfg: PipelineConfig,
                  device=None) -> dict:
    """One ROI-gated tracking step on the exact path (``[gh, gw]`` and
    ``[H, W]`` inputs): ``boxes``, ``valid``, ``areas``, ``box``,
    ``any_active`` and ``region_pct`` of the pair."""
    dev = _build.resolve_device(device)
    mem, prev, nxt = roi_ops.as_batch((mem_u8, prev_gray, next_gray), dev)
    roi = gate(mem, cfg)
    flow_win, inbox = window_flow(prev, nxt, roi, cfg)
    out = _tracking_out(tracking_head_window(flow_win, inbox, roi["origin"], cfg), roi)
    out["region_pct"] = roi["region_pct"]
    return roi_ops.first(out)


def _full_frame_head(flow: torch.Tensor, cfg: PipelineConfig) -> dict:
    """The head on one full-frame ``[H, W, 2]`` flow (region (0, 0))."""
    dev = flow.device
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    inbox = torch.ones((1,) + flow.shape[:2], dtype=torch.bool, device=dev)
    return roi_ops.first(tracking_head_window(flow[None], inbox, (zero, zero), cfg))


def tracking_step_full(prev_gray, next_gray, cfg: PipelineConfig, device=None) -> dict:
    """The full-frame baseline (region_coords (0, 0, 0, 0),
    optical_flow_ob.py:625-630): the exact Farnebäck on the whole frame and
    the head."""
    dev = _build.resolve_device(device)
    return _full_frame_head(-farneback(prev_gray, next_gray, cfg.fb, device=dev), cfg)


def tracking_stages(cfg: PipelineConfig, device=None) -> dict:
    """:func:`~nsof_tpu_torch.pipelines.segmentation.roi_stages` plus the
    head stages 'task' ``(flow_win, inbox, origin, active)`` and
    'task_full' ``(flow)``.  The head maps boxes to image coordinates
    itself (the reference's combination step), so there is no 'comb'."""
    stages = roi_stages(cfg, device)
    dev = _build.resolve_device(device)

    def task(flow_win, inbox, origin, active):
        flow_win, inbox, origin, active = roi_ops.as_batch(
            (flow_win, inbox, origin, active), dev)
        out = tracking_head_window(flow_win, inbox, origin, cfg)
        out["valid"] = out["valid"] & active[:, None]
        return roi_ops.first(out)

    def task_full(flow):
        return _full_frame_head(torch.as_tensor(flow).to(dev), cfg)

    stages.update({"task": task, "task_full": task_full})
    return stages


def mean_iou_vs_gt(boxes: torch.Tensor, valid: torch.Tensor,
                   gt_box: torch.Tensor) -> torch.Tensor:
    """Mean IoU of the valid ``[N, 4]`` boxes against the GT max bbox with
    the reference's +1 convention (optical_flow_ob.py:589-609); 0 when no
    box is valid."""
    x1 = torch.maximum(boxes[:, 0], gt_box[0])
    y1 = torch.maximum(boxes[:, 1], gt_box[1])
    x2 = torch.minimum(boxes[:, 2], gt_box[2])
    y2 = torch.minimum(boxes[:, 3], gt_box[3])
    inter = (x2 - x1 + 1).clamp(min=0.0) * (y2 - y1 + 1).clamp(min=0.0)
    area = (boxes[:, 2] - boxes[:, 0] + 1) * (boxes[:, 3] - boxes[:, 1] + 1)
    gt_area = (gt_box[2] - gt_box[0] + 1) * (gt_box[3] - gt_box[1] + 1)
    iou = inter / (area + gt_area - inter)
    n = valid.sum()
    return torch.where(n > 0, torch.where(valid, iou, 0.0).sum() / n, 0.0)


def max_bbox_from_mask(mask: torch.Tensor, k_max: int = 32):
    """The bbox of the largest-rectangle 8-connected component of an
    ``[H, W]`` mask (get_max_bbox_from_mask, optical_flow_ob.py:137-180) →
    ((x1, y1, x2, y2) float32, found)."""
    stats = comp.component_stats_scatter(comp.label_components_sweep(mask[None], 8), k_max)
    boxes, valid = stats["boxes"][0], stats["valid"][0]
    rect_area = torch.where(valid, boxes[:, 2] * boxes[:, 3], -1)
    i = torch.argmax(rect_area)
    b = boxes[i]
    return torch.stack([b[0], b[1], b[0] + b[2], b[1] + b[3]]).float(), valid[i]
