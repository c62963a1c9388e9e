"""Synaptic-transistor (memristor) device model.

Counterpart of :mod:`nsof_tpu.device.model`: the nonlinear ion-drift model
of the reference simulators (frame-driven MATLAB
``simulation/simulationcode_v4_transistor_uav.m:173-236``, event-driven
``eventsim/event_mem_sim.py:40-63``).  State ``w`` lives in [0, 1]; a
voltage below ``v_off`` drives the OFF transition, above ``v_on`` the ON
transition:

    dw/dt = k_off * (V/v_off - 1)^alpha_off * (1 - w*s_off)^b_off   (V < v_off)
    dw/dt = k_on  * (V/v_on  - 1)^alpha_on  * (1 - w*s_on )^b_on    (V > v_on)
    dw/dt = 0                                                        otherwise

followed by an Euler step and a hard window clamp to [0, 1].

Every formula keeps the JAX module's order of operations and rounds once
per operation.  Divisions are true divisions: PyTorch evaluates
``tensor / number`` on the card, and ``number / tensor`` everywhere, as a
product with a reciprocal (two roundings), so a divisor or dividend that is
a Python number goes in as a 0-dim tensor (:func:`_div`, :func:`_rdiv`).
The device-scan kernel (``csrc/device_scan.cu``) computes the same
operations in the same order.
"""

from __future__ import annotations

import dataclasses
import math

import torch

# Integration timestep [s] shared by both reference simulators
# (eventsim/event_mem_sim.py:30, simulationcode_v4_transistor_uav.m:55).
DT = 5e-4


@dataclasses.dataclass(frozen=True)
class DeviceParams:
    """Physical constants of the 2-D vdW synaptic transistor.

    Defaults match the reference (eventsim/event_mem_sim.py:20-27 and the
    MATLAB ``params`` struct, simulationcode_v4_transistor_uav.m:26-33).
    """

    alpha_off: float = 1.0
    alpha_on: float = 1.0
    v_off: float = -0.2
    v_on: float = 0.1
    k_off: float = 51.03
    k_on: float = -2.91
    s_on: float = 0.2
    s_off: float = 0.8
    b_on: float = -5.12
    b_off: float = 3.10
    r_on: float = 163_305.0
    r_off: float = 2_104_377.0
    w_on: float = 1.0
    w_off: float = 0.0
    w_init: float = 0.5

    @property
    def lam(self) -> float:
        """Exponential resistance-map constant λ = ln(Roff/Ron)."""
        return math.log(self.r_off / self.r_on)


DEFAULT_PARAMS = DeviceParams()


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` rounded once."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _rdiv(c: float, x: torch.Tensor) -> torch.Tensor:
    """``c / x`` rounded once."""
    return torch.full((), c, dtype=x.dtype, device=x.device) / x


def dwdt(w, v, p: DeviceParams = DEFAULT_PARAMS) -> torch.Tensor:
    """Window-modulated state derivative: both branches evaluated densely
    and selected with ``where``."""
    w = _f32(w)
    v = _f32(v)
    off = v < p.v_off
    on = v > p.v_on
    # the power bases of the inactive branch are clamped to 0, so it never
    # produces NaN; ``where`` discards it
    drive_off = torch.clamp_min(_div(v, p.v_off) - 1.0, 0.0)
    drive_on = torch.clamp_min(_div(v, p.v_on) - 1.0, 0.0)
    win_off = torch.pow(1.0 - w * p.s_off, p.b_off)
    win_on = torch.pow(1.0 - w * p.s_on, p.b_on)
    d_off = p.k_off * torch.pow(drive_off, p.alpha_off) * win_off
    d_on = p.k_on * torch.pow(drive_on, p.alpha_on) * win_on
    return torch.where(off, d_off, torch.where(on, d_on, 0.0))


def update_state(w, v, p: DeviceParams = DEFAULT_PARAMS, dt: float = DT) -> torch.Tensor:
    """One Euler step of the device state with the window clamp to [0, 1]
    (the reference's ``update_state``, eventsim/event_mem_sim.py:40-57)."""
    return torch.clamp(_f32(w) + dwdt(w, v, p) * dt, 0.0, 1.0)


def resistance_exp(w, p: DeviceParams = DEFAULT_PARAMS) -> torch.Tensor:
    """State w∈[0,1] → resistance on the exponential curve
    R = Ron / exp(-λ (1 - w)) (eventsim/event_mem_sim.py:60-63)."""
    return _rdiv(p.r_on, torch.exp(-p.lam * (1.0 - _f32(w))))


def resistance_linear(w, p: DeviceParams = DEFAULT_PARAMS) -> torch.Tensor:
    """Linear state→resistance map (calculate_resistances_linear, .m:229-231)."""
    return p.r_on + (p.r_off - p.r_on) * _f32(w)


def state_from_resistance(r, p: DeviceParams = DEFAULT_PARAMS) -> torch.Tensor:
    """Inverse of :func:`resistance_exp`: w = 1 - ln(R/Ron)/λ
    (eventsim/visualize_npz_keyframes.py:30-33)."""
    return 1.0 - _div(torch.log(_div(_f32(r), p.r_on)), p.lam)


def conductance_to_gray(g) -> torch.Tensor:
    """Conductance map → uint8 gray: clip(-3366 / log10(G) - 306, 0, 255),
    truncated (optical_flow_seg.py:426-435).  Non-positive inputs map to 0.
    Float32 unless ``g`` is float64."""
    g = torch.as_tensor(g)
    if g.dtype != torch.float64:
        g = g.to(torch.float32)
    pos = g > 0
    logg = torch.log10(torch.where(pos, g, 1.0))
    val = torch.where(pos, _rdiv(-3366.0, logg) - 306.0, 0.0)
    return torch.clamp(val, 0.0, 255.0).to(torch.uint8)


def modulate_voltage(v, a: float = 0.3, b: float = 0.0, c: float = 3.0,
                     d: float = -3.0) -> torch.Tensor:
    """Piecewise-linear drive modulation with the global sign flip
    (MATLAB ``modulatefunc``, .m:332-347): -(a·V + b) for V > 0,
    -(c·V + d) for V < 0, and -b at V == 0."""
    v = _f32(v)
    pos = a * v + b
    neg = c * v + d
    return -torch.where(v > 0, pos, torch.where(v < 0, neg, b))


def difference_voltage(prev, curr, th1: float, th2: float) -> torch.Tensor:
    """|Δ| → voltage transfer of the frame-driven simulator
    (``calculate_difference_matrix`` + ``func1/2/3``, .m:146-171):
    (d - 5.5)·0.6 for d ≤ th1, else (d + 4)·0.75 (func3 == func2 in v4)."""
    d = torch.abs(_f32(curr) - _f32(prev))
    low = (d - 5.5) * 0.6
    high = (d + 4.0) * 0.75
    return torch.where(d <= th1, low, high)
