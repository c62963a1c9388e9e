"""Event-driven memristor-array simulator.

Counterpart of :mod:`nsof_tpu.device.event_sim` (the reference's
``eventsim/event_mem_sim.py``): the stream is binned once into dense
per-slice arrays on the host (:func:`bin_events`, the native binner or
numpy), and the state is integrated slice by slice on the device.

Two schemes, matching the reference:

- **V1 boxcar** (:207-227): pixels with ≥ ``theta_events`` events in a
  window receive ``active_v``, others ``silent_v``; one state update per
  window.
- **V2 DC-bias + overlay** (:230-286): constant ``silent_v`` bias plus
  per-event ``active_v`` overlays with a per-pixel refractory period;
  ``polarity='split'`` drives two arrays (ON events → array A, OFF events
  with p == 0 → array B), ``polarity='magnitude'`` one.

A pixel's overlay in a slice is allowed iff ``next_ok[pixel] <= t_first``,
the timestamp of the first event of the slice (global, :243); accepted
pixels set ``next_ok = t_last + refractory_us`` (:247).  Times are int32
microseconds, shifted by ``time_offset`` across chunks.

The JAX package compiles the whole simulation into one program.  Here each
slice is one eager state update (about 25 small launches, no kernel of its
own), and snapshots follow the JAX package's grouping: one after the first
slice of each group of ``max(1, T // n_snapshots)`` slices; slices with
``valid`` False leave the state alone.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from nsof_tpu_torch import _build, native
from nsof_tpu_torch.device.model import (DEFAULT_PARAMS, DT, DeviceParams, resistance_exp,
                                         update_state)


@dataclasses.dataclass
class BinnedEvents:
    """Dense per-slice event arrays (time rebased to the window anchor),
    leading dimension T = number of slices; timestamps are int32 µs."""

    counts: np.ndarray  # [T, H, W] uint8 event counts (clipped at 255)
    on_any: np.ndarray  # [T, H, W] bool, any event with p == 1
    off_any: np.ndarray  # [T, H, W] bool, any event with p == 0
    any_ev: np.ndarray  # [T, H, W] bool, any event at all
    t_first: np.ndarray  # [T] int32, ts of first event in slice (0 if empty)
    t_last: np.ndarray  # [T] int32, ts of last event in slice (0 if empty)
    valid: np.ndarray  # [T] bool, slice contains real data (not padding)
    height: int = 0
    width: int = 0
    slice_us: int = 1000


def bin_events(x, y, p, t_us, slice_us: int = 1000, height: Optional[int] = None,
               width: Optional[int] = None, use_native: bool = True,
               t_origin: Optional[int] = None,
               n_slices: Optional[int] = None) -> BinnedEvents:
    """Bin an event stream into fixed-duration windows.

    Window boundaries replicate the reference's ``slice_indices``
    (eventsim/event_mem_sim.py:78-83): ``arange(t[0], t[-1]+slice_us,
    slice_us)``, the final partial window kept; ``height``/``width``
    default to ``max+1`` (:69-75).  ``t_origin``/``n_slices`` override the
    window anchor and count (the chunked drivers keep the window phase
    continuous with them).

    ``use_native`` (the default) bins with the C++ binner
    (:func:`nsof_tpu_torch.native.bin_events_native`) and raises
    ``RuntimeError`` when it cannot be built; ``use_native=False`` takes the
    numpy path.  Both give the same arrays.
    """
    x = np.asarray(x)
    y = np.asarray(y)
    p = np.asarray(p).astype(np.int64)
    t_us = np.asarray(t_us).astype(np.int64)
    if height is None:
        height = int(y.max()) + 1 if y.size else 1
    if width is None:
        width = int(x.max()) + 1 if x.size else 1
    h, w = height, width

    if use_native:
        if not native.native_available():
            raise RuntimeError(f"the native event binner cannot be built: "
                               f"{native.build_error()}; pass use_native=False")
        nat = native.bin_events_native(x, y, p, t_us, slice_us, h, w, t_origin, n_slices)
        if nat is not None:
            return BinnedEvents(
                counts=nat["counts"], on_any=nat["on_any"], off_any=nat["off_any"],
                any_ev=nat["counts"] > 0, t_first=nat["t_first"], t_last=nat["t_last"],
                valid=np.ones(nat["nt"], bool), height=h, width=w, slice_us=slice_us)

    if t_us.size == 0:
        nt0 = n_slices or 0
        z = np.zeros((nt0, h, w), np.uint8)
        zb = np.zeros((nt0, h, w), bool)
        zt = np.zeros((nt0,), np.int32)
        return BinnedEvents(z, zb, zb, zb, zt, zt, np.ones(nt0, bool), h, w, slice_us)

    t0 = t_us[0] if t_origin is None else int(t_origin)
    t_rel = (t_us - t0).astype(np.int64)
    if n_slices is None:
        bounds = np.arange(0, t_rel[-1] + slice_us, slice_us, dtype=np.int64)
    else:
        bounds = np.arange(0, (n_slices + 1) * slice_us, slice_us, dtype=np.int64)
    idx = np.searchsorted(t_rel, bounds)
    nt = len(idx) - 1
    if nt <= 0:
        z = np.zeros((0, h, w), np.uint8)
        zb = np.zeros((0, h, w), bool)
        zt = np.zeros((0,), np.int32)
        return BinnedEvents(z, zb, zb, zb, zt, zt, zt.astype(bool), h, w, slice_us)

    # event i belongs to slice j iff idx[j] <= i < idx[j+1]; events at or
    # after the final boundary are dropped (event_mem_sim.py:78-83)
    sl_of_ev = np.searchsorted(idx, np.arange(t_rel.size), side="right") - 1
    keep = (sl_of_ev >= 0) & (sl_of_ev < nt)
    sl_of_ev, x, y, p = sl_of_ev[keep], x[keep], y[keep], p[keep]

    lin = sl_of_ev * (h * w) + y.astype(np.int64) * w + x.astype(np.int64)
    counts = np.bincount(lin, minlength=nt * h * w).reshape(nt, h, w)
    on = np.bincount(lin[p == 1], minlength=nt * h * w).reshape(nt, h, w) > 0
    off = np.bincount(lin[p == 0], minlength=nt * h * w).reshape(nt, h, w) > 0

    t_first = np.zeros(nt, np.int64)
    t_last = np.zeros(nt, np.int64)
    has = idx[1:] > idx[:-1]
    t_first[has] = t_rel[idx[:-1][has]]
    t_last[has] = t_rel[idx[1:][has] - 1]

    return BinnedEvents(
        counts=np.minimum(counts, 255).astype(np.uint8), on_any=on, off_any=off,
        any_ev=counts > 0, t_first=t_first.astype(np.int32),
        t_last=t_last.astype(np.int32), valid=np.ones(nt, bool), height=h, width=w,
        slice_us=slice_us)


@dataclasses.dataclass(frozen=True)
class EventSimConfig:
    """Knobs of the event simulator (CLI defaults, event_mem_sim.py:334-352)."""

    version: int = 1
    active_v: float = -6.0
    silent_v: float = 0.0
    polarity: str = "split"  # 'split' | 'magnitude' (version 2 only)
    theta_events: int = 1
    refractory_us: int = 800
    dt: float = DT
    params: DeviceParams = DEFAULT_PARAMS
    n_snapshots: int = 100  # aim for ~this many resistance snapshots


def _i32(values) -> np.ndarray:
    """int64 → int32 with two's-complement wrap, as JAX's int32 adds do."""
    return np.asarray(values, np.int64).astype(np.int32)


def simulate_events(binned: BinnedEvents, cfg: EventSimConfig = EventSimConfig(),
                    initial_state: Optional[dict] = None, time_offset: int = 0,
                    device=None) -> dict:
    """Run the event-driven device simulation.

    Returns ``w_final`` [H, W]; ``resistances`` [S, H, W] decimated
    snapshots; ``state`` (the carry for chunked continuation, see
    :func:`simulate_events_stream`); and, for version 2 'split',
    ``w_final_b`` / ``resistances_b`` of the OFF-event array (the
    reference's ``*.V2_b`` outputs, event_mem_sim.py:293-303), else empty
    tensors.  ``initial_state`` resumes from a prior chunk's ``state``;
    ``time_offset`` is added to the slices' timestamps so the refractory
    clocks run in stream time across chunks.  Runs on ``device`` (default
    the CUDA device; raises ``RuntimeError`` without one unless
    ``device='cpu'``)."""
    if cfg.version not in (1, 2) or cfg.polarity not in ("split", "magnitude"):
        raise ValueError(f"unknown scheme: version {cfg.version}, polarity {cfg.polarity}")
    dev = _build.resolve_device(device)
    p = cfg.params
    h, w = binned.height, binned.width
    t = binned.counts.shape[0]
    n_arrays = 2 if (cfg.version == 2 and cfg.polarity == "split") else 1
    if initial_state is None:
        state = {
            "w": (torch.full((h, w), p.w_init, dtype=torch.float32, device=dev),) * n_arrays,
            "next_ok": (torch.zeros((h, w), dtype=torch.int32, device=dev),) * n_arrays,
        }
    else:
        state = {k: tuple(torch.as_tensor(a).to(dev) for a in v)
                 for k, v in initial_state.items()}
    empty = torch.zeros((0,), dtype=torch.float32, device=dev)
    if t == 0:
        return {"w_final": state["w"][0], "resistances": torch.zeros(
            (0, h, w), dtype=torch.float32, device=dev),
            "w_final_b": empty, "resistances_b": empty, "state": state}
    group = max(1, t // cfg.n_snapshots)
    valid = np.asarray(binned.valid, bool)
    ws, next_ok = list(state["w"]), list(state["next_ok"])
    snaps: list[list[torch.Tensor]] = [[] for _ in range(n_arrays)]
    if cfg.version == 1:
        active = torch.from_numpy(np.ascontiguousarray(binned.counts)).to(dev) >= cfg.theta_events
    else:
        masks = (binned.on_any, binned.off_any) if n_arrays == 2 else (binned.any_ev,)
        masks = [torch.from_numpy(np.ascontiguousarray(m)).to(dev) for m in masks]
        t_first = _i32(np.asarray(binned.t_first, np.int64) + _i32(time_offset))
        t_last = _i32(np.asarray(binned.t_last, np.int64) + _i32(time_offset))
        refire = _i32(t_last.astype(np.int64) + cfg.refractory_us)
    for i in range(t):
        if valid[i]:
            if cfg.version == 1:
                v = torch.where(active[i], cfg.active_v, cfg.silent_v)
                ws[0] = update_state(ws[0], v, p, cfg.dt)
            else:
                for k in range(n_arrays):
                    ok = masks[k][i] & (next_ok[k] <= int(t_first[i]))
                    v = torch.where(ok, cfg.silent_v + cfg.active_v, cfg.silent_v)
                    ws[k] = update_state(ws[k], v, p, cfg.dt)
                    next_ok[k] = next_ok[k].masked_fill(ok, int(refire[i]))
        if i % group == 0:
            for k in range(n_arrays):
                snaps[k].append(resistance_exp(ws[k], p))
    out = {"w_final": ws[0], "resistances": torch.stack(snaps[0]),
           "state": {"w": tuple(ws), "next_ok": tuple(next_ok)}}
    if n_arrays == 2:
        out["w_final_b"] = ws[1]
        out["resistances_b"] = torch.stack(snaps[1])
    else:
        out["w_final_b"] = empty
        out["resistances_b"] = empty
    return out


def simulate_events_stream(x, y, p, t_us, slice_us: int = 1000,
                           cfg: EventSimConfig = EventSimConfig(),
                           chunk_slices: int = 4096, height: Optional[int] = None,
                           width: Optional[int] = None, device=None) -> dict:
    """Chunked long-stream simulation: bins and integrates ``chunk_slices``
    windows at a time, carrying the state (w arrays and refractory clocks)
    across chunks, so memory stays bounded whatever the stream's length.

    Returns the :func:`simulate_events` dict without ``state``, snapshots
    concatenated across chunks."""
    dev = _build.resolve_device(device)
    if height is None:
        height = int(np.asarray(y).max()) + 1 if len(y) else 1
    if width is None:
        width = int(np.asarray(x).max()) + 1 if len(x) else 1
    t_us = np.asarray(t_us).astype(np.int64)
    if t_us.size == 0:
        return simulate_events(bin_events(x, y, p, t_us, slice_us, height, width), cfg,
                               device=dev)
    t0 = t_us[0]
    span = chunk_slices * slice_us
    n_chunks = int((t_us[-1] - t0) // span) + 1
    x, y, p = np.asarray(x), np.asarray(y), np.asarray(p)
    carry, final = None, None
    res, res_b = [], []
    for ci in range(n_chunks):
        lo = int(t0 + ci * span)
        sel = (t_us >= lo) & (t_us < lo + span)
        # anchor every chunk at its own start and bin exactly chunk_slices
        # windows, so the window phase runs on across chunks
        binned = bin_events(x[sel], y[sel], p[sel], t_us[sel], slice_us, height, width,
                            t_origin=lo, n_slices=chunk_slices)
        final = simulate_events(binned, cfg, initial_state=carry, time_offset=ci * span,
                                device=dev)
        carry = final["state"]
        res.append(final["resistances"])
        if cfg.version == 2 and cfg.polarity == "split":
            res_b.append(final["resistances_b"])
    return {
        "w_final": final["w_final"],
        "resistances": torch.cat(res),
        "w_final_b": final["w_final_b"],
        "resistances_b": torch.cat(res_b) if res_b else final["resistances_b"],
    }


def simulate_events_reference(binned: BinnedEvents,
                              cfg: EventSimConfig = EventSimConfig()) -> dict:
    """Plain oracle with the same slice semantics, on the CPU, for tests:
    the reference's per-slice loop (numpy masks and clocks) over the port's
    model functions; returns numpy arrays."""
    p = cfg.params
    h, w = binned.height, binned.width
    t = binned.counts.shape[0]
    group = max(1, t // cfg.n_snapshots)

    def step(w_arr, v):
        return update_state(torch.from_numpy(w_arr), torch.from_numpy(v.astype(np.float32)),
                            p, cfg.dt).numpy()

    def res_of(w_arr):
        return resistance_exp(torch.from_numpy(w_arr), p).numpy()

    w_a = np.full((h, w), p.w_init, np.float32)
    res = []
    if cfg.version == 1:
        for i in range(t):
            v = np.where(binned.counts[i] >= cfg.theta_events, cfg.active_v, cfg.silent_v)
            w_a = step(w_a, v)
            if i % group == 0:
                res.append(res_of(w_a))
        return {"w_final": w_a, "resistances": np.stack(res)}

    split = cfg.polarity == "split"
    arrays = [w_a.copy() for _ in range(2 if split else 1)]
    next_ok = [np.zeros((h, w), np.int64) for _ in range(len(arrays))]
    hist: list[list[np.ndarray]] = [[] for _ in range(len(arrays))]
    mask_seq = [binned.on_any, binned.off_any] if split else [binned.any_ev]
    for i in range(t):
        for k in range(len(arrays)):
            ok = mask_seq[k][i] & (next_ok[k] <= binned.t_first[i])
            v = np.where(ok, cfg.silent_v + cfg.active_v, cfg.silent_v)
            arrays[k] = step(arrays[k], v)
            next_ok[k][ok] = binned.t_last[i] + cfg.refractory_us
            if i % group == 0:
                hist[k].append(res_of(arrays[k]))
    out = {"w_final": arrays[0], "resistances": np.stack(hist[0])}
    if split:
        out["w_final_b"] = arrays[1]
        out["resistances_b"] = np.stack(hist[1])
    return out
