"""FLAG=1 separate-regions pipelines (``process_separate_regions``).

Counterpart of :mod:`nsof_tpu.pipelines.separate`.  The reference's FLAG=1
mode computes one Farnebäck call per active device component and writes
each region's flow into the shared field, a later region overwriting an
earlier one (optical_flow_seg.py:123-166, ``flow[y0:y1, x0:x1] =
current_flow``), then runs the task head on the PADDING-extended union of
the regions (MERGE_FLAG=True, the configuration of every bundled FLAG=1
dataset) or per region (MERGE_FLAG=False, :273-299).

Every region uses the same static window (``cfg.sep_win_shape``).  The JAX
package walks the ``k_max`` component slots with a ``fori_loop`` whose
``lax.cond`` skips the inactive ones.  Here the valid slots are read on the
host once (one synchronisation a call), their windows go through the
exact Farnebäck as one batch, and the scatters run in slot order, so the
overwrites are the JAX package's.  Slot order is the labelling's ascending
root index, which may differ from cv2's discovery order only where two
EXTEND-padded regions overlap.  These entry points take one frame pair.
"""

from __future__ import annotations

import torch

from nsof_tpu_torch import _build
from nsof_tpu_torch.config import PipelineConfig
from nsof_tpu_torch.ops import roi as roi_ops
from nsof_tpu_torch.ops.farneback import farneback_batch
from nsof_tpu_torch.pipelines.prediction import warp_region
from nsof_tpu_torch.pipelines.segmentation import seg_head_window
from nsof_tpu_torch.pipelines.tracking import tracking_head_window


def union_box(boxes: torch.Tensor, valid: torch.Tensor, padding: int, image_h: int,
              image_w: int) -> torch.Tensor:
    """PADDING-extended union of the valid region boxes ``[..., k, 4]``
    (valid ``[..., k]``) → ``[..., 4]`` int32, zeros where none is valid
    (the MERGE_FLAG head's area, optical_flow_seg.py:273-277)."""
    big = 2**30
    v = valid[..., None]
    lo = torch.where(v, boxes[..., :2], big).amin(dim=-2) - padding
    hi = torch.where(v, boxes[..., 2:], -big).amax(dim=-2) + padding
    limit = torch.tensor([image_w, image_h], device=boxes.device)
    box = torch.cat([torch.clamp(lo, min=0), torch.clamp(hi, min=0)], dim=-1)
    box = torch.minimum(box, torch.cat([limit, limit]))
    return torch.where(valid.any(dim=-1, keepdim=True), box, 0).to(torch.int32)


def _slot_order(valid: torch.Tensor) -> list[int]:
    """The valid slots of one sample, ascending (one host read)."""
    return torch.nonzero(valid).flatten().tolist()


def separate_flow_field(mem_u8, prev_gray, next_gray, cfg: PipelineConfig,
                        device=None) -> dict:
    """Per-component ROI-gated flow of one pair assembled into a full-frame
    field.

    ``[gh, gw]`` uint8 state map and ``[H, W]`` uint8 frames → ``flow``
    [H, W, 2] in cv2's sign convention (callers negate it, as the reference
    does, optical_flow_seg.py:461), the per-slot ``boxes`` [k_max, 4],
    ``valid`` and ``region_pcts``, the MERGE head's ``union`` box and
    ``any_active``.  Runs on ``device`` (default the CUDA device; raises
    ``RuntimeError`` without one unless ``device='cpu'``)."""
    dev = _build.resolve_device(device)
    h, w = cfg.image_h, cfg.image_w
    swh, sww = cfg.sep_win_shape
    mem, prev, nxt = roi_ops.as_batch((mem_u8, prev_gray, next_gray), dev)
    r = roi_ops.roi_boxes(mem, h, w, cfg.roi)
    boxes, valid = r["boxes"][0], r["valid"][0]
    flow = torch.zeros((1, h, w, 2), dtype=torch.float32, device=dev)
    slots = _slot_order(valid)
    if slots:
        box = boxes[slots]
        oys, oxs = roi_ops.window_origin(box, swh, sww, h, w)
        n = len(slots)
        p_win = roi_ops.crop_windows(prev.expand(n, -1, -1), oys, oxs, swh, sww)
        n_win = roi_ops.crop_windows(nxt.expand(n, -1, -1), oys, oxs, swh, sww)
        fw = farneback_batch(p_win, n_win, cfg.fb, device=dev)
        inb = roi_ops.window_box_mask(box, oys, oxs, swh, sww)
        fw = torch.where(inb[..., None], fw, 0.0)
        for i in range(n):
            flow = roi_ops.scatter_window(flow, fw[i : i + 1], box[i : i + 1],
                                          oys[i : i + 1], oxs[i : i + 1])
    pcts = roi_ops.region_percentage(boxes, h, w) * valid
    return {
        "flow": flow[0],
        "boxes": boxes,
        "valid": valid,
        "region_pcts": pcts,
        "union": union_box(boxes, valid, cfg.roi.padding, h, w),
        "any_active": r["any_active"][0],
    }


def _union_window(flow: torch.Tensor, ub: torch.Tensor, active: torch.Tensor,
                  cfg: PipelineConfig):
    """The union box's head window of a full ``[H, W, 2]`` flow: the flow
    ``[1, wh, ww, 2]`` zeroed outside the box, the box mask and the origin."""
    wh, ww = cfg.win_shape
    oys, oxs = roi_ops.window_origin(ub[None], wh, ww, cfg.image_h, cfg.image_w)
    flow_win = roi_ops.crop_windows(flow[None], oys, oxs, wh, ww)
    inbox = roi_ops.window_box_mask(ub[None], oys, oxs, wh, ww) & active
    return torch.where(inbox[..., None], flow_win, 0.0), inbox, (oys, oxs)


def seg_step_separate(mem_u8, prev_gray, next_gray, cfg: PipelineConfig,
                      merge_head: bool = True, device=None) -> dict:
    """FLAG=1 motion segmentation of one pair.

    ``merge_head=True`` runs the seg head once on the PADDING-extended
    union region (MERGE_FLAG=True, optical_flow_seg.py:271-288); ``False``
    runs it on each region's window, the masks scattered in slot order
    (:289-299).  Returns ``mask``, ``flow`` (negated), ``boxes``, ``valid``,
    ``box`` (the union), ``any_active`` and ``region_pct`` (the regions'
    summed percentage).  Runs on ``device`` (default the CUDA device;
    raises ``RuntimeError`` without one unless ``device='cpu'``)."""
    dev = _build.resolve_device(device)
    h, w = cfg.image_h, cfg.image_w
    ff = separate_flow_field(mem_u8, prev_gray, next_gray, cfg, device=dev)
    flow = -ff["flow"]  # Farnebäck inversion (optical_flow_seg.py:461)
    active = ff["any_active"]
    mask = torch.zeros((1, h, w), dtype=torch.uint8, device=dev)
    if merge_head:
        ub = ff["union"]
        flow_win, inbox, (oys, oxs) = _union_window(flow, ub, active, cfg)
        mask = roi_ops.scatter_window(mask, seg_head_window(flow_win, inbox, cfg),
                                      ub[None], oys, oxs)
    else:
        swh, sww = cfg.sep_win_shape
        slots = _slot_order(ff["valid"])
        if slots:
            box = ff["boxes"][slots]
            oys, oxs = roi_ops.window_origin(box, swh, sww, h, w)
            n = len(slots)
            flow_win = roi_ops.crop_windows(flow[None].expand(n, -1, -1, -1), oys, oxs,
                                            swh, sww)
            inbox = roi_ops.window_box_mask(box, oys, oxs, swh, sww)
            mask_win = seg_head_window(torch.where(inbox[..., None], flow_win, 0.0),
                                       inbox, cfg)
            for i in range(n):
                mask = roi_ops.scatter_window(mask, mask_win[i : i + 1], box[i : i + 1],
                                              oys[i : i + 1], oxs[i : i + 1])
    return {
        "mask": mask[0],
        "flow": flow,
        "boxes": ff["boxes"],
        "valid": ff["valid"],
        "box": ff["union"],
        "any_active": active,
        "region_pct": ff["region_pcts"].sum(),
    }


def tracking_step_separate(mem_u8, prev_gray, next_gray, cfg: PipelineConfig,
                           device=None) -> dict:
    """FLAG=1 tracking of one pair with the MERGE_FLAG=True head (every
    bundled FLAG=1 dataset; optical_flow_ob.py:404-419): ``boxes``,
    ``valid``, ``areas``, ``box`` (the union), ``any_active``,
    ``region_pct``.  Runs on ``device`` (default the CUDA device; raises
    ``RuntimeError`` without one unless ``device='cpu'``)."""
    dev = _build.resolve_device(device)
    ff = separate_flow_field(mem_u8, prev_gray, next_gray, cfg, device=dev)
    active = ff["any_active"]
    ub = ff["union"]
    flow_win, inbox, origin = _union_window(-ff["flow"], ub, active, cfg)
    out = roi_ops.first(tracking_head_window(flow_win, inbox, origin, cfg))
    out["valid"] = out["valid"] & active
    out["box"] = ub
    out["any_active"] = active
    out["region_pct"] = ff["region_pcts"].sum()
    return out


def prediction_step_separate(mem_u8, prev_gray, next_gray, next_frame,
                             cfg: PipelineConfig, device=None) -> dict:
    """FLAG=1 prediction of one pair with the MERGE_FLAG=True head: the
    union region of the assembled flow warps ``next_frame``
    (optical_flow_prediction.py:276-300).  Returns ``pred``, ``flow``,
    ``box``, ``any_active``, ``region_pct``.  Runs on ``device`` (default
    the CUDA device; raises ``RuntimeError`` without one unless
    ``device='cpu'``)."""
    dev = _build.resolve_device(device)
    ff = separate_flow_field(mem_u8, prev_gray, next_gray, cfg, device=dev)
    flow = -ff["flow"]
    active = ff["any_active"]
    ub = torch.where(active, ff["union"], 0)
    frame = torch.as_tensor(next_frame).to(dev)
    return {
        "pred": warp_region(frame[None], flow[None], ub[None])[0],
        "flow": flow,
        "box": ub,
        "any_active": active,
        "region_pct": ff["region_pcts"].sum(),
    }
