"""Streaming end-to-end pipeline: frames in, ROI-gated masks out.

Counterpart of :mod:`nsof_tpu.pipelines.stream`, the paper's deployment
shape (camera → device → ROI → flow → task, continuously) where the
reference replays its two offline phases (the MATLAB device integration,
then a host loop over frame pairs, optical_flow_seg.py:390-622):

1. the frames are Lanczos-3 compressed onto the device grid and the
   synaptic-transistor state is integrated over them by kernel K8
   (:func:`nsof_tpu_torch.device.frame_sim.scan_device`, one launch for
   the stream), which emits each pair's gating map;
2. the maps gate :func:`~nsof_tpu_torch.pipelines.segmentation.
   seg_batch_fast` with the frame pairs as the batch.

:func:`stream_masks` makes no host synchronisation once the resize weights
of its frame size are on the device.  :func:`stream_masks_chunked` carries
``(w, last frame)`` across chunks in bounded memory and gives the one-shot
call's outputs bit for bit; :func:`stream_masks_from_events` gates the flow
with the event-driven device instead.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from nsof_tpu_torch import _build
from nsof_tpu_torch.config import PipelineConfig
from nsof_tpu_torch.device.event_sim import EventSimConfig, bin_events, simulate_events
from nsof_tpu_torch.device.frame_sim import FrameSimConfig, compress_frames, scan_device
from nsof_tpu_torch.device.model import _div
from nsof_tpu_torch.pipelines.segmentation import seg_batch_fast
from nsof_tpu_torch.utils.timing import span


def _seg_out(seg: dict, **extra) -> dict:
    return {"masks": seg["mask"], "boxes": seg["box"], "any_active": seg["any_active"],
            "region_pct": seg["region_pct"], **extra}


def stream_masks(frames_gray, cfg: PipelineConfig, sim: FrameSimConfig = FrameSimConfig(),
                 w0=None, warp_radius: int | None = None, kernel_mode: str = "auto",
                 return_flow: bool = False, device=None) -> dict:
    """Frames → device-state scan → ROI-gated batched seg masks.

    ``frames_gray`` ``[T, H, W]`` uint8, T ≥ 2; ``cfg.roi.memsize`` must
    equal ``sim.m``/``sim.n`` for the grid → image scaling to line up;
    ``w0`` ``[gh, gw]`` is the initial state (default ``w_init``; pass the
    previous chunk's ``w_final`` to continue a stream).

    Returns ``masks`` [T-1, H, W] uint8, ``boxes`` [T-1, 4], ``any_active``
    [T-1], ``region_pct`` [T-1], ``mem_gray`` [T-1, gh, gw] and ``w_final``
    [gh, gw]; with ``return_flow`` also ``flow`` [T-1, H, W, 2] (negated,
    zero outside the ROI).  Runs on ``device`` (default the CUDA device;
    raises ``RuntimeError`` without one unless ``device='cpu'``)."""
    with span("nsof.stream_masks"):
        dev = _build.resolve_device(device)
        frames = torch.as_tensor(frames_gray).to(dev)
        frames01 = _div(frames.to(torch.float32), 255.0)
        with span("nsof.frame_sim.compress"):
            comp = compress_frames(frames01, sim.m, sim.n, device=dev)
            del frames01  # four bytes a pixel of the chunk: not held through the flow
            if w0 is None:
                w0 = torch.full(comp.shape[1:], sim.params.w_init, dtype=torch.float32,
                                device=dev)
            else:
                w0 = torch.as_tensor(w0).to(dev)
        with span("nsof.frame_sim.scan"):
            w_final, mem_gray, _ = scan_device(comp, sim, w0)
        seg = seg_batch_fast(mem_gray, frames[:-1], frames[1:], cfg, warp_radius,
                             kernel_mode, return_flow=return_flow, device=dev)
    out = _seg_out(seg, mem_gray=mem_gray, w_final=w_final)
    if return_flow:
        out["flow"] = seg["flow"]
    return out


def stream_masks_from_events(x, y, p, t_us, frames_gray, frame_t_us, cfg: PipelineConfig,
                             event_hw: tuple[int, int], slice_us: int = 1000,
                             event_cfg: Optional[EventSimConfig] = None,
                             warp_radius: int | None = None, kernel_mode: str = "auto",
                             device=None) -> dict:
    """Hybrid serving: an event stream drives the device state, a
    synchronised frame stream gives the intensity for the ROI-gated flow.

    The events between consecutive frame timestamps (``frame_t_us`` [T],
    µs, the clock of ``t_us``) are binned (the native binner, anchored at
    the interval's start) and integrated by the event-driven device
    (:func:`~nsof_tpu_torch.device.event_sim.simulate_events`, default V1
    boxcar, magnitude polarity), the state carried across intervals; the
    state after each interval gates that frame pair.  ``event_hw`` is the
    (gh, gw) event grid; ``cfg.roi.memsize`` maps it onto the image.

    The gate is the state displacement ``u8(|w − w_init| · 255)``, as in
    the JAX package (the conductance→gray map saturates at 255 for states
    near ``w_init``); ``cfg.roi.thres`` is in displacement counts.

    Returns the :func:`stream_masks` keys ``masks``, ``boxes``,
    ``any_active``, ``region_pct``, with ``mem_gate`` (the displacement
    maps gated on) and ``state`` (the event-sim carry).  Runs on ``device``
    (default the CUDA device; raises ``RuntimeError`` without one unless
    ``device='cpu'``)."""
    dev = _build.resolve_device(device)
    if event_cfg is None:
        event_cfg = EventSimConfig(version=1, polarity="magnitude")
    gh, gw = event_hw
    frames = torch.as_tensor(frames_gray).to(dev)
    frame_t_us = np.asarray(frame_t_us, np.int64)
    n_pairs = frames.shape[0] - 1
    if frame_t_us.shape != (frames.shape[0],):
        raise ValueError(f"{frames.shape[0]} frames but {frame_t_us.shape} timestamps")
    x, y, p = np.asarray(x), np.asarray(y), np.asarray(p)
    t_us = np.asarray(t_us, np.int64)

    t0 = frame_t_us[0]
    carry = None
    gates = []
    for i in range(n_pairs):
        lo, hi = int(frame_t_us[i]), int(frame_t_us[i + 1])
        sel = (t_us >= lo) & (t_us < hi)
        n_slices = max(1, -(-(hi - lo) // slice_us))
        binned = bin_events(x[sel], y[sel], p[sel], t_us[sel], slice_us, gh, gw,
                            t_origin=lo, n_slices=n_slices)
        out = simulate_events(binned, event_cfg, initial_state=carry,
                              time_offset=int(lo - t0), device=dev)
        carry = out["state"]
        disp = torch.abs(out["w_final"] - event_cfg.params.w_init) * 255.0
        gates.append(torch.clamp(disp, 0, 255).to(torch.uint8))
    gate = torch.stack(gates)
    seg = seg_batch_fast(gate, frames[:-1], frames[1:], cfg, warp_radius, kernel_mode,
                         device=dev)
    return _seg_out(seg, mem_gate=gate, state=carry)


def stream_masks_chunked(frames_gray, cfg: PipelineConfig,
                         sim: FrameSimConfig = FrameSimConfig(), chunk_pairs: int = 64,
                         warp_radius: int | None = None, kernel_mode: str = "auto",
                         device=None) -> dict:
    """Chunked driver for unbounded streams in bounded device memory: runs
    :func:`stream_masks` on ``chunk_pairs`` frame pairs at a time, carrying
    ``(w_final, last frame)`` across chunks.

    The carry is the state after the chunk's true pairs.  The JAX package
    pads its tail chunk by repeating the last frame, so that every chunk
    reuses one compiled program, and then scans the true pairs again for
    the carry; eager PyTorch runs the tail chunk at its own length, whose
    ``w_final`` is that carry.  The outputs equal the one-shot call's bit
    for bit (the route of ``kernel_mode`` does not depend on the batch).
    Returns the :func:`stream_masks` keys but ``flow``, concatenated on
    ``device`` (default the CUDA device; raises ``RuntimeError`` without
    one unless ``device='cpu'``)."""
    dev = _build.resolve_device(device)
    frames = torch.as_tensor(frames_gray).to(dev)
    n_pairs = frames.shape[0] - 1
    w_carry = None
    parts = []
    for s in range(0, n_pairs, chunk_pairs):
        e = min(s + chunk_pairs, n_pairs)
        out = stream_masks(frames[s : e + 1], cfg, sim, w_carry, warp_radius, kernel_mode,
                           device=dev)
        w_carry = out["w_final"]
        parts.append(out)
    keys = ("masks", "boxes", "any_active", "region_pct", "mem_gray")
    res = {k: torch.cat([o[k] for o in parts]) for k in keys}
    res["w_final"] = w_carry
    return res
