"""ROI-gated deep flow backends (the reference's raft_seg.py / ff_seg.py):
the port of :mod:`nsof_tpu.pipelines.deep_flow`.

The deep pipelines differ from the Farnebäck ones in three ways
(codebase/RAFT/raft_seg.py): frames are resized to 1/3 (:62-72), the
device-cell size scales with them (MEMSIZE/3, :460-464), and the flow is
not negated (the ``flow = -flow`` inversion is Farnebäck-only,
optical_flow_seg.py:460).  Inference pads the window to a multiple of 8,
runs the model and unpads (runraft, :91-98).  Regions under 64 px on a
side are skipped (:133-135).

A :class:`DeepBackend` binds a RAFT or FlowFormer module to a device.  Every
ROI entry point crops its RGB windows with :func:`~nsof_tpu_torch.ops.roi.
crop_windows_batch`, kernel K1 on a CUDA tensor (a 3-byte element), and
raises when the window is larger than the frame.  The backend sees only
the rows the gate keeps, as the published pipelines skip the flow of a
frame without a region: at the end of the gate the active rows' indices
are read once a call, the one host synchronisation of a step; the model
runs on those n rows and its flow is copied into a zero ``[B, wh, ww,
2]`` window (no copy when every row is active, no model call when none
is).  The batched step :func:`deep_roi_flow_batch` runs the model once on
a true ``[n, wh, ww, 3]`` batch and pastes the windows, already zero
outside their boxes, into zero frames at their origins.

The backends leave PyTorch's precision settings as the caller has them.
On Hopper cuDNN's convolutions take TF32 by default, which moved the flow
of randomly initialised models by up to 2.1e-2 px on an H100; a caller
who wants float32 convolutions runs inside
``torch.backends.cudnn.flags(enabled=True, allow_tf32=False)``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

from nsof_tpu_torch import _build
from nsof_tpu_torch.config import PipelineConfig
from nsof_tpu_torch.ops import roi as roi_ops
from nsof_tpu_torch.pipelines.prediction import warp_region
from nsof_tpu_torch.pipelines.segmentation import seg_head_window, seg_head_window_batch
from nsof_tpu_torch.pipelines.tracking import tracking_head_window
from nsof_tpu_torch.utils.timing import count, span

MIN_REGION_PX = 64  # raft_seg.py:133-135


@dataclasses.dataclass
class DeepBackend:
    """A deep flow model bound to a device.

    ``apply(img1, img2) -> flow [B, H, W, 2]`` float32 on ``[B, H, W, 3]``
    RGB frames (H, W multiples of 8) on ``device``, without autograd."""

    apply: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    device: torch.device
    model: torch.nn.Module
    name: str = "raft"

    @classmethod
    def from_raft(cls, model, iters: int = 20, device=None) -> "DeepBackend":
        """RAFT's final full-resolution flow after ``iters`` refinements.
        The model moves to ``device`` (default the CUDA device; raises
        ``RuntimeError`` without one unless ``device='cpu'``), in eval mode,
        its parameters frozen."""
        dev = _build.resolve_device(device)
        model = model.to(dev).eval().requires_grad_(False)

        def apply(img1, img2):
            with torch.inference_mode():
                return model(img1, img2, iters=iters, test_mode=True)[1]

        return cls(apply=apply, device=dev, model=model, name="raft")

    @classmethod
    def from_flowformer(cls, model, device=None) -> "DeepBackend":
        """FlowFormer's final flow, on ``device`` as :meth:`from_raft`."""
        dev = _build.resolve_device(device)
        model = model.to(dev).eval().requires_grad_(False)

        def apply(img1, img2):
            with torch.inference_mode():
                return model(img1, img2, test_mode=True)

        return cls(apply=apply, device=dev, model=model, name="flowformer")


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """``[n_out, n_in]`` float32 weights of a bilinear resize without
    antialiasing: JAX's ``compute_weight_mat`` with the triangle kernel."""
    f32 = torch.float32
    inv_scale = torch.tensor(1.0 / (n_out / n_in), dtype=f32)
    sample = (torch.arange(n_out, dtype=f32) + 0.5) * inv_scale - 0.5
    x = (sample[:, None] - torch.arange(n_in, dtype=f32)[None, :]).abs()
    weights = (1.0 - x).clamp(min=0.0)
    total = weights.sum(dim=1, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * torch.finfo(f32).eps,
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[:, None], weights, 0.0).to(device)


def resize_third(img) -> torch.Tensor:
    """The deep pipelines' 1/3 input resize (raft_seg.py:62-72): bilinear,
    no antialiasing, ``[..., H, W, C]`` → float32 ``[..., H//3, W//3, C]``,
    as ``jax.image.resize(..., 'bilinear', antialias=False)``.  When 3
    divides a side, its output pixel i is input pixel 3i + 1."""
    img = torch.as_tensor(img)
    h, w = img.shape[-3:-1]
    x = img.to(torch.float32)
    wy = _resize_weights(h, h // 3, x.device)
    wx = _resize_weights(w, w // 3, x.device)
    x = torch.einsum("oh,...hwc->...owc", wy, x)
    return torch.einsum("pw,...owc->...opc", wx, x)


def _pad8(x: torch.Tensor) -> tuple[torch.Tensor, tuple[int, int]]:
    """Edge-pad ``[B, H, W, C]`` frames to multiples of 8 (half above and
    left, the odd pixel below and right) → (padded, (top, left))."""
    h, w = x.shape[1:3]
    ph, pw = (-h) % 8, (-w) % 8
    if not (ph or pw):
        return x, (0, 0)
    y = F.pad(x.permute(0, 3, 1, 2).float(), (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2),
              mode="replicate")
    return y.permute(0, 2, 3, 1), (ph // 2, pw // 2)


def _backend_flow(backend: DeepBackend, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """The backend's flow on ``[B, H, W, 3]`` frames of any size: padded to
    /8, run, unpadded."""
    h, w = img1.shape[1:3]
    p1, (t, left) = _pad8(img1)
    p2, _ = _pad8(img2)
    count("nsof.flow", rows=p1.shape[0], px=p1.shape[1] * p1.shape[2])
    return backend.apply(p1, p2)[:, t: t + h, left: left + w]


def _check_window(wh: int, ww: int, h: int, w: int) -> None:
    if wh > h or ww > w:
        raise ValueError(f"the deep ROI window {wh}x{ww} is larger than the {h}x{w} frame")


def _deep_roi_gate(mem, prev_rgb, next_rgb, cfg: PipelineConfig, backend: DeepBackend) -> dict:
    """The shared ROI gate and windowed deep flow of a batch: the merged
    (FLAG=2) box on the MEMSIZE/3 grid (raft_seg.py:460-464), active if
    both sides reach MIN_REGION_PX; the active rows' indices read on the
    host (the call's one synchronisation, at the end of ``nsof.gate``); the
    RGB windows cropped at its origin (K1 on the card) and the active rows'
    taken (``nsof.crop``); the backend's flow on those n rows only, copied
    into a zero window of B rows (``nsof.deep.flow``), zero outside the
    box.  Every output equals that of a backend run on all B rows: an
    inactive row's flow was zeroed anyway.  ``_build.COUNTS`` gains the rows
    the backend ran (``deep_flow_rows``) and those skipped
    (``deep_flow_rows_skipped``)."""
    dev = backend.device
    mem = torch.as_tensor(mem).to(dev)
    prev = torch.as_tensor(prev_rgb).to(dev).contiguous()
    nxt = torch.as_tensor(next_rgb).to(dev).contiguous()
    h, w = prev.shape[1:3]
    wh, ww = cfg.window_h or h, cfg.window_w or w
    _check_window(wh, ww, h, w)
    b = prev.shape[0]
    with span("nsof.gate"):
        roi_cfg = dataclasses.replace(cfg.roi, memsize=max(cfg.roi.memsize // 3, 1))
        r = roi_ops.roi_boxes(mem, h, w, roi_cfg)
        box = r["merged"]
        active = (r["any_active"] & ((box[:, 2] - box[:, 0]) >= MIN_REGION_PX)
                  & ((box[:, 3] - box[:, 1]) >= MIN_REGION_PX))
        oys, oxs = roi_ops.window_origin(box, wh, ww, h, w)
        region_pct = roi_ops.region_percentage(box, h, w)
        count("nsof.gate", rows=b, active=active, box=box, oys=oys, oxs=oxs, win=(wh, ww))
        # the call's one host synchronisation: the active rows, which alone
        # go through the backend
        idx = active.nonzero()[:, 0]
        n = idx.numel()
    _build.COUNTS["deep_flow_rows"] += n
    _build.COUNTS["deep_flow_rows_skipped"] += b - n
    if n:
        with span("nsof.crop"):
            p_win = roi_ops.crop_windows_batch(prev, oys, oxs, wh, ww)
            n_win = roi_ops.crop_windows_batch(nxt, oys, oxs, wh, ww)
            if n < b:  # the active rows' windows
                p_win, n_win = p_win[idx], n_win[idx]
    with span("nsof.deep.flow"):
        if 0 < n == b:
            flow_win = _backend_flow(backend, p_win, n_win)
        else:  # zero on the inactive rows
            flow_win = torch.zeros((b, wh, ww, 2), dtype=torch.float32, device=dev)
            if n:
                flow_win.index_copy_(0, idx, _backend_flow(backend, p_win, n_win))
    with span("nsof.head"):
        inbox = roi_ops.window_box_mask(box, oys, oxs, wh, ww) & active[:, None, None]
        flow_win = torch.where(inbox[..., None], flow_win, 0.0)
    return {
        "flow_win": flow_win,
        "inbox": inbox,
        "box": box,
        "origin": (oys, oxs),
        "any_active": active,
        "region_pct": region_pct,
        "hw": (h, w),
    }


def _paste(wins: torch.Tensor, oys: torch.Tensor, oxs: torch.Tensor, h: int,
           w: int) -> torch.Tensor:
    """Windows ``[B, wh, ww(, C)]`` copied into zero frames ``[B, H, W(, C)]``
    at their (in-frame) origins."""
    b, wh, ww = wins.shape[:3]
    dev = wins.device
    out = torch.zeros((b, h, w) + tuple(wins.shape[3:]), dtype=wins.dtype, device=dev)
    rows = oys.long()[:, None, None] + torch.arange(wh, device=dev)[None, :, None]
    cols = oxs.long()[:, None, None] + torch.arange(ww, device=dev)[None, None, :]
    out[torch.arange(b, device=dev)[:, None, None], rows, cols] = wins
    return out


def _scatter_flow(g: dict) -> torch.Tensor:
    b = g["flow_win"].shape[0]
    h, w = g["hw"]
    zeros = torch.zeros((b, h, w, 2), dtype=torch.float32, device=g["box"].device)
    return roi_ops.scatter_window(zeros, g["flow_win"], g["box"], *g["origin"])


def deep_roi_flow_step(mem_u8, prev_rgb, next_rgb, cfg: PipelineConfig,
                       backend: DeepBackend) -> dict:
    """One ROI-gated deep-flow segmentation step on 1/3-resized frames
    (``[gh, gw]`` state map, ``[H, W, 3]`` frames; raft_seg.py / ff_seg.py):
    gate, backend flow, flow scattered into a zero field, the seg head (no
    Farnebäck inversion).  Returns ``flow``, ``mask``, ``box``,
    ``any_active`` and ``region_pct``."""
    g = _deep_roi_gate(*roi_ops.as_batch((mem_u8, prev_rgb, next_rgb), backend.device), cfg,
                       backend)
    h, w = g["hw"]
    mask_win = seg_head_window(g["flow_win"], g["inbox"], cfg)
    mask = roi_ops.scatter_window(
        torch.zeros((1, h, w), dtype=torch.uint8, device=backend.device), mask_win, g["box"],
        *g["origin"])
    return roi_ops.first({"flow": _scatter_flow(g), "mask": mask, "box": g["box"],
                          "any_active": g["any_active"], "region_pct": g["region_pct"]})


def deep_roi_tracking_step(mem_u8, prev_rgb, next_rgb, cfg: PipelineConfig,
                           backend: DeepBackend) -> dict:
    """ROI-gated deep tracking (raft_ob.py / ff_ob.py): the seg step's gate,
    then the Farnebäck tracking head (HSV → gray → close → threshold →
    components → area filter → NMS) on the deep flow.  Returns ``boxes``,
    ``valid``, ``areas``, ``box``, ``any_active``, ``region_pct``."""
    g = _deep_roi_gate(*roi_ops.as_batch((mem_u8, prev_rgb, next_rgb), backend.device), cfg,
                       backend)
    out = tracking_head_window(g["flow_win"], g["inbox"], g["origin"], cfg)
    out["valid"] = out["valid"] & g["any_active"][:, None]
    out.update(box=g["box"], any_active=g["any_active"], region_pct=g["region_pct"])
    return roi_ops.first(out)


def deep_roi_prediction_step(mem_u8, prev_rgb, next_rgb, next_frame, cfg: PipelineConfig,
                             backend: DeepBackend) -> dict:
    """ROI-gated deep future-frame prediction (raft_prediction.py /
    ff_prediction.py): the deep flow scattered into the frame, the grid +
    flow remap inside the box, the frame passed through outside.  Returns
    ``pred``, ``flow``, ``box``, ``any_active``, ``region_pct``."""
    dev = backend.device
    g = _deep_roi_gate(*roi_ops.as_batch((mem_u8, prev_rgb, next_rgb), dev), cfg, backend)
    flow = _scatter_flow(g)
    box_eff = torch.where(g["any_active"][:, None], g["box"], 0)
    pred = warp_region(torch.as_tensor(next_frame).to(dev)[None], flow, box_eff)
    return roi_ops.first({"pred": pred, "flow": flow, "box": g["box"],
                          "any_active": g["any_active"], "region_pct": g["region_pct"]})


def deep_roi_flow_batch(mem_u8, prev_rgb, next_rgb, cfg: PipelineConfig,
                        backend: DeepBackend) -> dict:
    """The batched ROI-gated deep segmentation step: ``[B, gh, gw]`` state
    maps and ``[B, H, W, 3]`` frame pairs → ``flow`` [B, H, W, 2], ``mask``
    [B, H, W], ``box`` [B, 4], ``any_active`` [B], ``region_pct`` [B].

    The gate runs on the batch and reads its active rows' indices once (the
    call's one host synchronisation); the windows are cropped by K1 (on the
    card) and the active rows' go through the backend as one batch, their
    flow copied into a zero window of B rows; the seg head thresholds
    |flow|² (:func:`seg_head_window_batch`, as the JAX batch step does); the
    windows, zero outside their boxes, are pasted into zero frames.  The
    spans: ``nsof.deep_roi_flow_batch`` holds ``nsof.gate`` (with the index
    read), ``nsof.crop`` (with the active rows' gather; absent when no row
    is active), ``nsof.deep.flow`` (the padding, the backend's spans, the
    unpadding, the copy into the B rows),
    ``nsof.head`` twice (the box mask and the flow's masking, then the seg
    head) and ``nsof.scatter``."""
    with span("nsof.deep_roi_flow_batch"):
        g = _deep_roi_gate(mem_u8, prev_rgb, next_rgb, cfg, backend)
        h, w = g["hw"]
        oys, oxs = g["origin"]
        with span("nsof.head"):
            mask_win = seg_head_window_batch(g["flow_win"], g["inbox"], cfg)
        with span("nsof.scatter"):
            out = {
                "flow": _paste(g["flow_win"], oys, oxs, h, w),
                "mask": _paste(mask_win, oys, oxs, h, w),
                "box": g["box"],
                "any_active": g["any_active"],
                "region_pct": g["region_pct"],
            }
    return out


def _full_flow(prev_rgb, next_rgb, backend: DeepBackend) -> torch.Tensor:
    dev = backend.device
    prev, nxt = (torch.as_tensor(x).to(dev)[None] for x in (prev_rgb, next_rgb))
    return _backend_flow(backend, prev, nxt)


def deep_full_flow_step(prev_rgb, next_rgb, cfg: PipelineConfig, backend: DeepBackend) -> dict:
    """The full-frame segmentation baseline of the deep pipelines: ``flow``
    ``[H, W, 2]`` and ``mask`` ``[H, W]``."""
    flow = _full_flow(prev_rgb, next_rgb, backend)
    mask = seg_head_window(flow, torch.ones(flow.shape[:3], dtype=torch.bool,
                                            device=flow.device), cfg)
    return {"flow": flow[0], "mask": mask[0]}


def deep_full_tracking_step(prev_rgb, next_rgb, cfg: PipelineConfig,
                            backend: DeepBackend) -> dict:
    """The full-frame tracking baseline (raft_ob.py's full path): the head
    on the whole frame's flow, region (0, 0)."""
    flow = _full_flow(prev_rgb, next_rgb, backend)
    zero = torch.zeros(1, dtype=torch.int32, device=flow.device)
    inbox = torch.ones(flow.shape[:3], dtype=torch.bool, device=flow.device)
    return roi_ops.first(tracking_head_window(flow, inbox, (zero, zero), cfg))


def deep_full_prediction_step(prev_rgb, next_rgb, next_frame, cfg: PipelineConfig,
                              backend: DeepBackend) -> dict:
    """The full-frame prediction baseline (raft_prediction.py's full path):
    the whole frame warped by the whole frame's flow."""
    flow = _full_flow(prev_rgb, next_rgb, backend)
    h, w = flow.shape[1:3]
    box = torch.tensor([[0, 0, w, h]], dtype=torch.int32, device=flow.device)
    pred = warp_region(torch.as_tensor(next_frame).to(flow.device)[None], flow, box)
    return {"pred": pred[0], "flow": flow[0]}
