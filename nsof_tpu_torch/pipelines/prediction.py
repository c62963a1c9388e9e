"""Future-frame prediction (``optical_flow_prediction.py``), batched over B.

Counterpart of :mod:`nsof_tpu.pipelines.prediction`.  Head: inside the ROI
box, the *next* frame is resampled at ``grid + flow`` (cv2.remap,
INTER_LINEAR, BORDER_REPLICATE, optical_flow_prediction.py:281-300; the
coordinates may leave the box, since the reference samples the full
frame); outside the box the prediction is the next frame unchanged.  The
quality metric is the SSIM of channel 2 against the true frame i+2
(calculateIntegralError, :113-115).

Entry points: :func:`prediction_batch_fast` (the throughput path: K1 crops
and the fast Farnebäck), :func:`prediction_step` and
:func:`prediction_step_full` (the exact path, no kernel) and
:func:`prediction_stages` (the dual-path replay stages).
"""

from __future__ import annotations

import torch

from nsof_tpu_torch import _build
from nsof_tpu_torch.config import PipelineConfig
from nsof_tpu_torch.ops import roi as roi_ops
from nsof_tpu_torch.ops.farneback import farneback
from nsof_tpu_torch.ops.ssim import ssim
from nsof_tpu_torch.ops.warp import warp_by_flow
from nsof_tpu_torch.pipelines.segmentation import (fast_window_flow, gate, roi_stages,
                                                   window_flow)


def warp_region(next_frame: torch.Tensor, flow: torch.Tensor,
                box: torch.Tensor) -> torch.Tensor:
    """Remap ``next_frame`` ``[B, H, W(, C)]`` by grid + ``flow`` ``[B, H, W,
    2]`` inside each sample's ``box`` ``[B, 4]`` only; outside it the pixels
    pass through."""
    h, w = next_frame.shape[1:3]
    warped = warp_by_flow(next_frame, flow)
    dev = next_frame.device
    col = torch.arange(w, device=dev)[None, None, :]
    row = torch.arange(h, device=dev)[None, :, None]
    bx = box[:, :, None, None]
    inbox = (col >= bx[:, 0]) & (col < bx[:, 2]) & (row >= bx[:, 1]) & (row < bx[:, 3])
    if next_frame.ndim == 4:
        inbox = inbox[..., None]
    return torch.where(inbox, warped, next_frame)


def _predict(next_frame, flow_win, roi, cfg: PipelineConfig) -> dict:
    """Scatter the windowed flow into the frame and warp the active boxes."""
    b = flow_win.shape[0]
    box, (oys, oxs) = roi["box"], roi["origin"]
    flow = roi_ops.scatter_window(
        torch.zeros((b, cfg.image_h, cfg.image_w, 2), dtype=torch.float32,
                    device=flow_win.device), flow_win, box, oys, oxs)
    box_eff = torch.where(roi["active"][:, None], box, 0)
    return {"pred": warp_region(next_frame, flow, box_eff), "flow": flow, "box": box,
            "any_active": roi["active"]}


def prediction_batch_fast(mem_u8, prev_gray, next_gray, next_frame, cfg: PipelineConfig,
                          warp_radius: int | None = None, kernel_mode: str = "auto",
                          device=None) -> dict:
    """Throughput prediction: the batched ROI gate, K1 crops, the fast
    Farnebäck in ``kernel_mode`` and the region warp.

    ``[B, gh, gw]`` uint8 state maps, ``[B, H, W]`` uint8 frames and the
    ``[B, H, W(, C)]`` next frames → ``pred`` (next_frame's shape and
    dtype), ``flow`` [B, H, W, 2], ``box`` [B, 4], ``any_active`` [B].  Runs
    on ``device`` (default the CUDA device; raises ``RuntimeError`` without
    one unless ``device='cpu'``)."""
    dev = _build.resolve_device(device)
    mem = torch.as_tensor(mem_u8).to(dev)
    prev = torch.as_tensor(prev_gray).to(dev).contiguous()
    nxt = torch.as_tensor(next_gray).to(dev).contiguous()
    roi = gate(mem, cfg)
    flow_win, _ = fast_window_flow(
        prev, nxt, roi, cfg, cfg.warp_radius if warp_radius is None else warp_radius,
        kernel_mode)
    return _predict(torch.as_tensor(next_frame).to(dev), flow_win, roi, cfg)


def prediction_step(mem_u8, prev_gray, next_gray, next_frame, cfg: PipelineConfig,
                    device=None) -> dict:
    """One ROI-gated prediction step on the exact path (``[gh, gw]``,
    ``[H, W]`` and ``[H, W(, C)]`` inputs): ``pred``, ``flow``, ``box``,
    ``any_active`` and ``region_pct`` of the pair."""
    dev = _build.resolve_device(device)
    mem, prev, nxt, frame = roi_ops.as_batch((mem_u8, prev_gray, next_gray, next_frame), dev)
    roi = gate(mem, cfg)
    flow_win, _ = window_flow(prev, nxt, roi, cfg)
    out = _predict(frame, flow_win, roi, cfg)
    out["region_pct"] = roi["region_pct"]
    return roi_ops.first(out)


def _full_box(cfg: PipelineConfig, device) -> torch.Tensor:
    return torch.tensor([[0, 0, cfg.image_w, cfg.image_h]], dtype=torch.int32,
                        device=device)


def prediction_step_full(prev_gray, next_gray, next_frame, cfg: PipelineConfig,
                         device=None) -> dict:
    """The full-frame baseline (optical_flow_prediction.py:581-597): the
    exact Farnebäck on the whole frame and the warp of the whole frame."""
    dev = _build.resolve_device(device)
    flow = -farneback(prev_gray, next_gray, cfg.fb, device=dev)
    frame = torch.as_tensor(next_frame).to(dev)
    pred = warp_region(frame[None], flow[None], _full_box(cfg, dev))[0]
    return {"pred": pred, "flow": flow}


def prediction_stages(cfg: PipelineConfig, device=None) -> dict:
    """:func:`~nsof_tpu_torch.pipelines.segmentation.roi_stages` plus
    'comb' ``(flow_win, box, origin)``, the scatter of the windowed flow
    into the frame, 'task' ``(next_frame, flow, box, active)``, the region
    warp, and 'task_full' ``(next_frame, flow)``, the full-frame warp."""
    h, w = cfg.image_h, cfg.image_w
    stages = roi_stages(cfg, device)
    dev = _build.resolve_device(device)

    def comb(flow_win, box, origin):
        flow_win, box, (oy, ox) = roi_ops.as_batch((flow_win, box, origin), dev)
        zeros = torch.zeros((1, h, w, 2), dtype=torch.float32, device=dev)
        return roi_ops.scatter_window(zeros, flow_win, box, oy, ox)[0]

    def task(next_frame, flow, box, active):
        frame, flow, box, active = roi_ops.as_batch((next_frame, flow, box, active), dev)
        return warp_region(frame, flow, torch.where(active[:, None], box, 0))[0]

    def task_full(next_frame, flow):
        frame, flow = roi_ops.as_batch((next_frame, flow), dev)
        return warp_region(frame, flow, _full_box(cfg, dev))[0]

    stages.update({"comb": comb, "task": task, "task_full": task_full})
    return stages


def prediction_ssim(pred: torch.Tensor, true_future: torch.Tensor) -> torch.Tensor:
    """SSIM of channel 2 (R of a BGR frame) against the true frame i+2,
    data_range 255 (optical_flow_prediction.py:113-115); ``[B, H, W, C]``
    → ``[B]``, ``[H, W, C]`` → a scalar."""
    return ssim(true_future[..., 2], pred[..., 2], data_range=255.0)
