"""Frame-driven memristor-array simulator.

Counterpart of :mod:`nsof_tpu.device.frame_sim` (the MATLAB pipeline
``simulation/simulationcode_v4_transistor_{uav,vehicle}.m``): consecutive
grayscale frames are cropped, Lanczos-3 downsampled onto the device grid,
turned into a drive voltage through the piecewise |Δ| transfer and the
modulation function, then integrated with ``n_substeps`` Euler sub-steps
per frame pair.

The integration, :func:`scan_device`, is kernel K8 (``csrc/
device_scan.cu``) on a CUDA tensor: one launch for the whole stream, where
the JAX package compiles a ``lax.scan`` over pairs holding a ``fori_loop``
over sub-steps into one program.  On a CPU tensor it is the plain version,
:func:`scan_device_plain`, the eager loop over the model functions.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from nsof_tpu_torch import _build
from nsof_tpu_torch.device.model import (DEFAULT_PARAMS, DeviceParams, _rdiv,
                                         conductance_to_gray, difference_voltage,
                                         modulate_voltage, resistance_exp, update_state)
from nsof_tpu_torch.ops.resize import full_f32_matmul, weight_mat


@dataclasses.dataclass(frozen=True)
class FrameSimConfig:
    """The MATLAB script's constants: ``m``/``n`` are the downsample
    factors (px per device cell), ``th1``/``th2`` the |Δ| thresholds
    (simulationcode_v4_transistor_uav.m:37-41; the vehicle variant uses
    m=n=200, th1=2, .m:38-51)."""

    m: int = 40
    n: int = 40
    th1: float = 0.7
    th2: float = 1.5
    dt: float = 5e-4
    n_substeps: int = 1000
    params: DeviceParams = DEFAULT_PARAMS


def compress_frames(frames, m: int, n: int, region_ul: Optional[tuple[int, int]] = None,
                    region_lr: Optional[tuple[int, int]] = None,
                    device=None) -> torch.Tensor:
    """Crop to the processing region and Lanczos-3 downsample to the grid
    (``crop_image`` + ``compress_image``, simulationcode_v4_transistor_uav.m:
    104-121): ``[T, H, W]`` float frames in [0, 1] → ``[T, H // n, W // m]``.

    The resize is ``jax.image.resize(..., "lanczos3", antialias=True)``:
    JAX's weight matrices applied as two float32 matrix products, rows
    first, as its einsum contracts them; an axis whose size does not change
    is left alone.  ``region_ul``/``region_lr`` are inclusive 0-based
    [y, x] corners.  Runs on ``device`` (default the CUDA device; raises
    ``RuntimeError`` without one unless ``device='cpu'``)."""
    dev = _build.resolve_device(device)
    frames = torch.as_tensor(frames).to(dev)
    if region_ul is not None and region_lr is not None:
        (y0, x0), (y1, x1) = region_ul, region_lr
        frames = frames[:, y0 : y1 + 1, x0 : x1 + 1]
    out = frames.to(torch.float32)
    _, h, w = out.shape
    gh, gw = h // n, w // m
    with full_f32_matmul():  # sample positions rounded twice: the output kept bit for bit
        if gh != h:
            out = torch.matmul(weight_mat(h, gh, "lanczos3", str(dev), False).T, out)
        if gw != w:
            out = torch.matmul(out, weight_mat(w, gw, "lanczos3", str(dev), False))
    return out


def scan_device_plain(frames01: torch.Tensor, sim: FrameSimConfig, w0: torch.Tensor,
                      keep_states: bool = False):
    """K8's plain version: the eager loop over the model functions.  See
    :func:`scan_device`."""
    p = sim.params
    scaled = frames01.to(torch.float32) * 256.0
    dt_sub = sim.dt / sim.n_substeps
    w = w0.to(torch.float32)
    grays, states = [], []
    for t in range(scaled.shape[0] - 1):
        v_mod = modulate_voltage(difference_voltage(scaled[t], scaled[t + 1],
                                                    sim.th1, sim.th2))
        for _ in range(sim.n_substeps):
            w = update_state(w, v_mod, p, dt_sub)
        states.append(w)
        grays.append(conductance_to_gray(_rdiv(1.0, resistance_exp(w, p))))
    shape = (0,) + tuple(w.shape)
    mem_gray = (torch.stack(grays) if grays else
                torch.zeros(shape, dtype=torch.uint8, device=w.device))
    if not keep_states:
        return w, mem_gray, None
    return w, mem_gray, (torch.stack(states) if states else
                         torch.zeros(shape, dtype=torch.float32, device=w.device))


def _scan_device_cuda(frames01, sim, w0, keep_states, substeps=None):
    """K8's launch.  ``substeps``, an int32 CUDA tensor of ``w0.numel()``
    elements or None (the main path), receives the substeps each cell ran
    over all pairs: K8 ends a pair's substeps at the state's fixed point."""
    if frames01.dtype != torch.float32 or w0.dtype != torch.float32:
        raise ValueError("scan_device: frames and w0 must be float32")
    t = frames01.shape[0]
    if t < 1 or tuple(w0.shape) != tuple(frames01.shape[1:]):
        raise ValueError(f"scan_device: frames {tuple(frames01.shape)} and w0 "
                         f"{tuple(w0.shape)} do not match")
    if w0.device != frames01.device:
        raise ValueError("scan_device: frames and w0 on different devices")
    if substeps is not None and (substeps.dtype != torch.int32 or substeps.device != w0.device
                                 or substeps.numel() != w0.numel()
                                 or not substeps.is_contiguous()):
        raise ValueError("scan_device: substeps must be a contiguous int32 tensor of "
                         "w0's size on its device")
    frames01 = frames01.contiguous()
    w0 = w0.contiguous()
    n_cells = w0.numel()
    dev = frames01.device
    w_final = torch.empty_like(w0)
    mem_gray = torch.empty((t - 1,) + tuple(w0.shape), dtype=torch.uint8, device=dev)
    states = (torch.empty((t - 1,) + tuple(w0.shape), dtype=torch.float32, device=dev)
              if keep_states else None)
    p = sim.params
    fn = _build.launcher("device_scan", 6, 3, n_float=14)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(fn(
        frames01.data_ptr(), w0.data_ptr(), w_final.data_ptr(), mem_gray.data_ptr(),
        states.data_ptr() if keep_states else None,
        substeps.data_ptr() if substeps is not None else None,
        t - 1, n_cells, sim.n_substeps,
        sim.th1, p.v_off, p.v_on, p.k_off, p.k_on, p.s_off, p.s_on, p.b_off, p.b_on,
        p.alpha_off, p.alpha_on, p.r_on, -p.lam, sim.dt / sim.n_substeps, stream,
    ), "device_scan")
    _build.LAUNCHES["device_scan"] += 1
    return w_final, mem_gray, states


def power_mismatches(pairs, device=None) -> list[int]:
    """K8's proof of its main-path power: for each ``(s, b)`` of ``pairs``,
    the count of float32 w in [0, 1] (every bit pattern from +0 to 1) for
    which that power of ``1 − w·s`` differs from ``powf`` in any bit, in
    one launch on the card (see ``csrc/device_scan.cu``)."""
    dev = _build.resolve_device(device)
    s = torch.tensor([p[0] for p in pairs], dtype=torch.float32, device=dev)
    b = torch.tensor([p[1] for p in pairs], dtype=torch.float32, device=dev)
    out = torch.zeros(len(pairs), dtype=torch.int64, device=dev)
    fn = _build.launcher("device_scan", 3, 1, symbol="nsof_device_scan_pow_check")
    _build.check(fn(s.data_ptr(), b.data_ptr(), out.data_ptr(), len(pairs),
                    torch.cuda.current_stream(dev).cuda_stream), "device_scan_pow_check")
    return out.tolist()


def scan_device(frames01: torch.Tensor, sim: FrameSimConfig, w0: torch.Tensor,
                keep_states: bool = False):
    """Integrate the device over ``[T, gh, gw]`` compressed frames in
    [0, 1] from the state ``w0`` ``[gh, gw]`` (the JAX package's
    ``pipelines/stream.py::_scan_device_maps``).

    Returns ``(w_final [gh, gw], mem_gray [T-1, gh, gw] uint8, states)``:
    ``mem_gray[t]`` is the conductance→gray map of the state after pair
    (t, t+1), the reference's ``memimg2`` gating map (optical_flow_seg.py:
    417/219); ``states`` is ``[T-1, gh, gw]``, the state after each pair,
    with ``keep_states``, else None.  A CUDA tensor goes through kernel K8,
    a CPU tensor through :func:`scan_device_plain`."""
    if frames01.is_cuda:
        return _scan_device_cuda(frames01, sim, w0, keep_states)
    return scan_device_plain(frames01, sim, w0, keep_states)


def simulate_frames(compressed, cfg: FrameSimConfig = FrameSimConfig(),
                    device=None) -> dict:
    """Run the device over ``[T, gh, gw]`` compressed frames in [0, 1]
    (``simulate_memristor_array``, simulationcode_v4_transistor_uav.m:
    187-227).  The integration is :func:`scan_device` with the per-pair
    states kept (K8 on the card); the other outputs are element-wise.

    Returns ``w_final`` [gh, gw]; ``resistances`` [T, gh, gw], the
    exponential resistance map of the initial state and after every pair;
    ``diff_voltages`` [T-1, gh, gw], the modulated drive voltages;
    ``value_matrices`` [T-1, gh, gw], the raw |Δ|·256 maps.  Runs on
    ``device`` (default the CUDA device; raises ``RuntimeError`` without one
    unless ``device='cpu'``)."""
    dev = _build.resolve_device(device)
    p = cfg.params
    comp = torch.as_tensor(compressed).to(dev).to(torch.float32)
    scaled = comp * 256.0  # MATLAB: double(img)*256 (.m:204)
    w0 = torch.full(comp.shape[1:], p.w_init, dtype=torch.float32, device=dev)
    w_final, _, states = scan_device(comp, cfg, w0, keep_states=True)
    prev, curr = scaled[:-1], scaled[1:]
    return {
        "w_final": w_final,
        "resistances": torch.cat([resistance_exp(w0, p)[None], resistance_exp(states, p)]),
        "diff_voltages": modulate_voltage(difference_voltage(prev, curr, cfg.th1, cfg.th2)),
        "value_matrices": torch.abs(curr - prev),
    }


def simulate_frames_fast(compressed, cfg: FrameSimConfig = FrameSimConfig(),
                         device=None) -> dict:
    """Single-substep variant (the MATLAB 'fast simulation' toggle, .m:56-59)."""
    return simulate_frames(compressed, dataclasses.replace(cfg, n_substeps=1), device)
