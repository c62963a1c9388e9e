"""ROI-gated motion segmentation: the port's main path and the dual path.

Counterpart of :mod:`nsof_tpu.pipelines.segmentation`.  Per frame pair the
device-state map gates the merged (FLAG=2) ROI; a static-size window is
cropped at the ROI's origin; Farnebäck flow is computed on the window; the
head thresholds the flow magnitude and smooths the mask with N × (dilate ∘
erode) under the ellipse, re-masking to the box between steps to emulate
the reference's morphology on the cropped region; and the mask is
scattered back into the frame.

- :func:`seg_batch_fast`, the throughput path: the crop is K1, the flow the
  fast Farnebäck (the fused route, K2–K4, or for presets beyond its halos
  the level route, K5 and K6), the head (K10) thresholds |flow|², and the
  scatter of the mask and the flow into their frames is K13.
- The exact path, which launches no kernel: :func:`seg_batch` on a batch,
  :func:`seg_step` on one pair, :func:`seg_step_full` on the whole frame,
  and the per-stage programs of the reference's dual-path replay,
  :func:`roi_stages` and :func:`seg_stages`.  It crops by indexing, runs the
  exact Farnebäck and thresholds sqrt(fx² + fy²), as the JAX package's
  exact path does.
"""

from __future__ import annotations

import torch

from nsof_tpu_torch import _build
from nsof_tpu_torch.config import PipelineConfig
from nsof_tpu_torch.ops import colorspace as cs
from nsof_tpu_torch.ops import morphology_fast
from nsof_tpu_torch.ops import roi as roi_ops
from nsof_tpu_torch.ops.farneback import farneback, farneback_batch
from nsof_tpu_torch.ops.farneback_fast import farneback_fast
from nsof_tpu_torch.ops.morphology import ellipse_se
from nsof_tpu_torch.ops.morphology_fast import dilate_erode_n_masked
from nsof_tpu_torch.utils.timing import count, span


def _seg_head_mag2(dx: torch.Tensor, dy: torch.Tensor, inbox: torch.Tensor,
                   cfg: PipelineConfig) -> torch.Tensor:
    """Seg head on the flow planes ``[B, h, w]``: |flow|² > SEG_TH², then
    N × (dilate ∘ erode) → ``[B, h, w]`` uint8 {0, 255} (the JAX package's
    ``_seg_head_mag2_hwb``, batch first); K10 on the card."""
    se = ellipse_se(cfg.head.morph_ksize, cfg.head.morph_ksize)
    return morphology_fast.seg_head(dx, dy, inbox, cfg.head.seg_th**2, se,
                                    cfg.head.morph_iters)


def seg_head_window_batch(flow_win: torch.Tensor, inbox: torch.Tensor,
                          cfg: PipelineConfig) -> torch.Tensor:
    """Batched seg head: ``[B, h, w, 2]`` flow + ``[B, h, w]`` box mask →
    ``[B, h, w]`` uint8 {0, 255}."""
    return _seg_head_mag2(flow_win[..., 0], flow_win[..., 1], inbox.bool(), cfg)


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
    with span("nsof.seg_batch_fast"):
        dev = _build.resolve_device(device)
        if warp_radius is None:
            warp_radius = cfg.warp_radius
        h, w = cfg.image_h, cfg.image_w
        wh, ww = cfg.win_shape
        mem = torch.as_tensor(mem_u8).to(dev)
        prev = torch.as_tensor(prev_gray).to(dev).contiguous()
        nxt = torch.as_tensor(next_gray).to(dev).contiguous()

        with span("nsof.gate"):
            r = roi_ops.roi_boxes(mem, h, w, cfg.roi)
            box = r["merged"]
            active = r["any_active"]
            oys, oxs = roi_ops.window_origin(box, wh, ww, h, w)
            region_pct = roi_ops.region_percentage(box, h, w)
            count("nsof.gate", rows=box.shape[0], active=active, box=box, oys=oys, oxs=oxs,
                  win=(wh, ww))
        with span("nsof.crop"):
            p_win = roi_ops.crop_windows_batch(prev, oys, oxs, wh, ww)
            n_win = roi_ops.crop_windows_batch(nxt, oys, oxs, wh, ww)

        # the head needs only |flow|², so the Farnebäck sign flip is skipped
        dx, dy = farneback_fast(p_win, n_win, cfg.fb, warp_radius, kernel_mode,
                                out_layout="planes", device=dev)
        with span("nsof.head"):
            # made after the Farnebäck: B window-sized bytes held through its peak otherwise
            inbox = roi_ops.window_box_mask(box, oys, oxs, wh, ww) & active[:, None, None]
            mask_win = _seg_head_mag2(dx, dy, inbox, cfg)
        with span("nsof.scatter"):
            # K13: the mask and, with return_flow, the negated flow, zero outside the box
            mask, flow = roi_ops.scatter_seg_windows(mask_win, dx, dy, box, active, oys, oxs,
                                                     h, w, return_flow)
            out = {"mask": mask, "box": box, "any_active": active, "region_pct": region_pct}
            if return_flow:
                out["flow"] = flow
    return out


def seg_head_window(flow_win: torch.Tensor, inbox: torch.Tensor,
                    cfg: PipelineConfig) -> torch.Tensor:
    """The reference seg head on windows ``[..., h, w, 2]`` restricted to
    ``inbox`` ``[..., h, w]`` → uint8 {0, 255} ``[..., h, w]``: |flow| >
    SEG_TH, then N × (dilate; erode) with the ellipse, the box's border
    emulated by re-masking (optical_flow_seg.py:322-357).  Only the sqrt
    threshold differs from :func:`_seg_head_mag2`."""
    x = (cs.magnitude(flow_win[..., 0], flow_win[..., 1]) > cfg.head.seg_th) & inbox
    se = ellipse_se(cfg.head.morph_ksize, cfg.head.morph_ksize)
    return dilate_erode_n_masked(x, inbox, se, cfg.head.morph_iters).to(torch.uint8) * 255


def gate(mem: torch.Tensor, cfg: PipelineConfig) -> dict:
    """The batched 'cal' stage: ``[B, gh, gw]`` state maps → the merged
    ROI ``box`` [B, 4], ``active`` [B], the window ``origin`` (oys, oxs) and
    ``region_pct`` [B]."""
    h, w = cfg.image_h, cfg.image_w
    wh, ww = cfg.win_shape
    r = roi_ops.roi_boxes(mem, h, w, cfg.roi)
    box = r["merged"]
    return {
        "box": box,
        "active": r["any_active"],
        "origin": roi_ops.window_origin(box, wh, ww, h, w),
        "region_pct": roi_ops.region_percentage(box, h, w),
    }


def _in_box(flow_win: torch.Tensor, roi: dict, cfg: PipelineConfig):
    """Window flow zeroed outside each active sample's box, and that box
    mask ``[B, wh, ww]``."""
    inbox = roi_ops.window_box_mask(roi["box"], *roi["origin"], *cfg.win_shape)
    inbox = inbox & roi["active"][:, None, None]
    return torch.where(inbox[..., None], flow_win, 0.0), inbox


def window_flow(prev: torch.Tensor, nxt: torch.Tensor, roi: dict,
                cfg: PipelineConfig):
    """The batched 'vel' stage: the exact Farnebäck on each sample's window
    (cropped by indexing), negated (optical_flow_seg.py:461) and zeroed
    outside its box → ``(flow_win [B, wh, ww, 2], inbox [B, wh, ww])``."""
    p_win = roi_ops.crop_windows(prev, *roi["origin"], *cfg.win_shape)
    n_win = roi_ops.crop_windows(nxt, *roi["origin"], *cfg.win_shape)
    return _in_box(-farneback_batch(p_win, n_win, cfg.fb, device=prev.device), roi, cfg)


def fast_window_flow(prev: torch.Tensor, nxt: torch.Tensor, roi: dict,
                     cfg: PipelineConfig, warp_radius: int, kernel_mode: str):
    """:func:`window_flow` on the throughput paths: K1 crops and the fast
    Farnebäck in ``kernel_mode``."""
    p_win = roi_ops.crop_windows_batch(prev, *roi["origin"], *cfg.win_shape)
    n_win = roi_ops.crop_windows_batch(nxt, *roi["origin"], *cfg.win_shape)
    flow_win = -farneback_fast(p_win, n_win, cfg.fb, warp_radius, kernel_mode,
                               device=prev.device)
    return _in_box(flow_win, roi, cfg)


def seg_batch(mem_u8, prev_gray, next_gray, cfg: PipelineConfig,
              device=None) -> dict:
    """The exact ROI-gated segmentation of a batch (the JAX package's
    ``seg_step`` on each pair): ``[B, gh, gw]`` uint8 state maps and
    ``[B, H, W]`` uint8 frames → ``mask`` [B, H, W] uint8, ``flow``
    [B, H, W, 2] (negated, zero outside the ROI), ``box``, ``any_active``,
    ``region_pct``.  Runs on ``device`` (default the CUDA device; raises
    ``RuntimeError`` without one unless ``device='cpu'``)."""
    dev = _build.resolve_device(device)
    mem = torch.as_tensor(mem_u8).to(dev)
    prev = torch.as_tensor(prev_gray).to(dev)
    nxt = torch.as_tensor(next_gray).to(dev)
    h, w = cfg.image_h, cfg.image_w
    roi = gate(mem, cfg)
    flow_win, inbox = window_flow(prev, nxt, roi, cfg)
    mask_win = seg_head_window(flow_win, inbox, cfg)
    b = mem.shape[0]
    box, (oys, oxs) = roi["box"], roi["origin"]
    zeros = torch.zeros((b, h, w), dtype=torch.uint8, device=dev)
    return {
        "mask": roi_ops.scatter_window(zeros, mask_win, box, oys, oxs),
        "flow": roi_ops.scatter_window(
            torch.zeros((b, h, w, 2), dtype=torch.float32, device=dev),
            flow_win, box, oys, oxs),
        "box": box,
        "any_active": roi["active"],
        "region_pct": roi["region_pct"],
    }


def seg_step(mem_u8, prev_gray, next_gray, cfg: PipelineConfig,
             device=None) -> dict:
    """One ROI-gated segmentation step: :func:`seg_batch` on one pair
    (``[gh, gw]`` and ``[H, W]`` inputs, unbatched outputs)."""
    dev = _build.resolve_device(device)
    args = roi_ops.as_batch((mem_u8, prev_gray, next_gray), dev)
    return roi_ops.first(seg_batch(*args, cfg, device=dev))


def seg_step_full(prev_gray, next_gray, cfg: PipelineConfig, device=None) -> dict:
    """The full-frame baseline: the exact Farnebäck on the whole ``[H, W]``
    frame and the same head (optical_flow_seg.py:492-541)."""
    dev = _build.resolve_device(device)
    flow = -farneback(prev_gray, next_gray, cfg.fb, device=dev)
    inbox = torch.ones(flow.shape[:2], dtype=torch.bool, device=dev)
    return {"mask": seg_head_window(flow, inbox, cfg), "flow": flow}


def roi_stages(cfg: PipelineConfig, device=None) -> dict:
    """The ROI and flow stages of the reference's per-stage replay
    (optical_flow_seg.py:51-59, 211-252), one frame pair a call, as the
    runner calls them: 'cal' maps a ``[gh, gw]`` state map to the ROI
    descriptor, 'vel' computes the windowed flow (negated, masked) and its
    box mask from ``(prev, next, mem, roi)``, 'vel_full' the full-frame
    flow.  ``cfg.roi.mode`` picks the merged FLAG=2 box or, for 1, the
    separate regions: 'cal' gives their PADDING-extended union and summed
    ``region_pct``, 'vel' crops the head window from the per-component flow
    field (:func:`~nsof_tpu_torch.pipelines.separate.separate_flow_field`)."""
    from nsof_tpu_torch.pipelines.separate import separate_flow_field, union_box

    dev = _build.resolve_device(device)
    h, w = cfg.image_h, cfg.image_w
    wh, ww = cfg.win_shape
    separate = cfg.roi.mode == 1

    def cal(mem_u8):
        mem = roi_ops.as_batch(mem_u8, dev)
        if not separate:
            return roi_ops.first(gate(mem, cfg))
        r = roi_ops.roi_boxes(mem, h, w, cfg.roi)
        box = union_box(r["boxes"], r["valid"], cfg.roi.padding, h, w)
        pct = (roi_ops.region_percentage(r["boxes"], h, w) * r["valid"]).sum(dim=1)
        return roi_ops.first({"box": box, "active": r["any_active"],
                              "origin": roi_ops.window_origin(box, wh, ww, h, w),
                              "region_pct": pct})

    def vel(prev_gray, next_gray, mem_u8, roi):
        if not separate:
            args = roi_ops.as_batch((prev_gray, next_gray, roi), dev)
            return roi_ops.first(window_flow(*args, cfg))
        ff = separate_flow_field(mem_u8, prev_gray, next_gray, cfg, device=dev)
        roi = roi_ops.as_batch(roi, dev)
        flow_win = roi_ops.crop_windows(-ff["flow"][None], *roi["origin"], wh, ww)
        return roi_ops.first(_in_box(flow_win, roi, cfg))

    def vel_full(prev_gray, next_gray):
        return -farneback(prev_gray, next_gray, cfg.fb, device=dev)

    return {"cal": cal, "vel": vel, "vel_full": vel_full}


def seg_stages(cfg: PipelineConfig, device=None) -> dict:
    """:func:`roi_stages` plus the seg head stages: 'task' (the head on the
    window), 'comb' (the scatter into the frame) and 'task_full' (the head
    on the full-frame flow)."""
    h, w = cfg.image_h, cfg.image_w
    stages = roi_stages(cfg, device)
    dev = _build.resolve_device(device)

    def task(flow_win, inbox):
        return seg_head_window(flow_win, inbox, cfg)

    def comb(mask_win, box, origin):
        mask_win, box, origin = roi_ops.as_batch((mask_win, box, origin), dev)
        zeros = torch.zeros((1, h, w), dtype=torch.uint8, device=dev)
        return roi_ops.scatter_window(zeros, mask_win, box, *origin)[0]

    def task_full(flow):
        return seg_head_window(flow, torch.ones((h, w), dtype=torch.bool,
                                                device=dev), cfg)

    stages.update({"task": task, "comb": comb, "task_full": task_full})
    return stages


def pixel_accuracy(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """calculate_pixel_accuracy (optical_flow_seg.py:384-388): % of equal
    pixels."""
    return 100.0 * (pred == gt).to(torch.float32).mean()
