"""The frame-driven device simulation, as the benchmark's reference.

Frames are scaled to [0, 1], Lanczos-3 downsampled onto the device grid
(``jax.image.resize``'s antialiased weights, applied as two matrix products,
rows first), then the synaptic-transistor state of every cell is
integrated over each frame pair with ``n_substeps`` Euler steps of the
ion-drift model (clamped to [0, 1]), and each pair's state is mapped to a
gray gating value by the conductance curve.

The resize weights are built exactly as the port builds them (float32,
each sample position rounded twice), so that the compressed frames, and
with them which side of the |Δ| threshold a cell falls on, come out the
same; the integration is written afresh and runs in float64, or in the
control's lower precision.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# the device's constants (the reference simulators' defaults)
DEVICE = dict(alpha_off=1.0, alpha_on=1.0, v_off=-0.2, v_on=0.1, k_off=51.03, k_on=-2.91,
              s_on=0.2, s_off=0.8, b_on=-5.12, b_off=3.10, r_on=163_305.0,
              r_off=2_104_377.0, w_init=0.5)


def lanczos3_weights(in_size: int, out_size: int) -> torch.Tensor:
    """``[in_size, out_size]`` float32 antialiased Lanczos-3 weights."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    f32 = torch.float32
    sample = torch.arange(out_size, dtype=f32) + 0.5
    sample = sample * inv_scale - 0.0 - 0.5
    x = torch.abs(sample[None, :] - torch.arange(in_size, dtype=f32)[:, None])
    x = x / torch.tensor(kernel_scale, dtype=f32)
    y = 3.0 * torch.sin(math.pi * x) * torch.sin(math.pi * x / 3.0)
    den = torch.where(x != 0, math.pi**2 * (x * x), 1.0)
    wts = torch.where(x > 3.0, 0.0, torch.where(x > 1e-3, y / den, 1.0))
    total = wts.sum(dim=0, keepdim=True)
    wts = torch.where(torch.abs(total) > 1000.0 * float(torch.finfo(f32).eps),
                      wts / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], wts, 0.0)


def compress(frames_u8: torch.Tensor, m: int, n: int, dt=torch.float32) -> torch.Tensor:
    """``[T, H, W]`` uint8 → ``[T, H // n, W // m]`` in [0, 1]."""
    dev = frames_u8.device
    x = frames_u8.to(dt) / torch.full((), 255.0, dtype=dt, device=dev)
    _, h, w = x.shape
    gh, gw = h // n, w // m
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        if gh != h:
            x = torch.matmul(lanczos3_weights(h, gh).to(dev, dt).T, x)
        if gw != w:
            x = torch.matmul(x, lanczos3_weights(w, gw).to(dev, dt))
    finally:
        torch.set_float32_matmul_precision(saved)
    return x


def scan(comp, sim: dict, w0, xp=np):
    """Integrate the state over ``[T, gh, gw]`` compressed frames from
    ``w0`` ``[gh, gw]`` with the array module ``xp``: numpy arrays in
    float64 (the reference) or tensors in their own dtype (``xp=torch``,
    the control).  Returns ``(w_final, gray)``, ``gray`` ``[T-1, gh, gw]``
    the uint8 gating value of each pair's state."""
    p = DEVICE
    scaled = comp * 256.0
    dt_sub = sim["dt"] / sim["n_substeps"]
    lam = math.log(p["r_off"] / p["r_on"])
    w = w0
    grays = []
    for t in range(comp.shape[0] - 1):
        d = abs(scaled[t + 1] - scaled[t])
        v = xp.where(d <= sim["th1"], (d - 5.5) * 0.6, (d + 4.0) * 0.75)
        # the modulation: -(0.3 v) for v > 0, -(3 v - 3) for v < 0, 0 at 0
        vm = -xp.where(v > 0, 0.3 * v, xp.where(v < 0, 3.0 * v - 3.0, 0.0 * v))
        off, on = vm < p["v_off"], vm > p["v_on"]
        drive_off = (vm / p["v_off"] - 1.0).clip(0.0, None) ** p["alpha_off"]
        drive_on = (vm / p["v_on"] - 1.0).clip(0.0, None) ** p["alpha_on"]
        coef = xp.where(off, p["k_off"] * drive_off,
                        xp.where(on, p["k_on"] * drive_on, 0.0 * vm)) * dt_sub
        s = xp.where(off, p["s_off"] + 0.0 * vm, p["s_on"] + 0.0 * vm)
        b = xp.where(off, p["b_off"] + 0.0 * vm, p["b_on"] + 0.0 * vm)
        for _ in range(sim["n_substeps"]):
            w_new = (w + coef * (1.0 - w * s) ** b).clip(0.0, 1.0)
            if bool((w_new == w).all()):
                break  # every later substep of the pair maps w to itself
            w = w_new
        # conductance G = exp(-lam (1 - w)) / r_on, gray = -3366 / log10 G - 306
        log_g = xp.log10(xp.exp(-lam * (1.0 - w)) / p["r_on"])
        grays.append((-3366.0 / log_g - 306.0).clip(0.0, 255.0))
    gray = xp.stack(grays) if grays else None
    return w, gray
