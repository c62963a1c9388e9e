"""Colour-space and normalisation ops with OpenCV's integer semantics.

Counterpart of :mod:`nsof_tpu.ops.colorspace`: the tracking head's chain
``cartToPolar`` → HSV image → ``HSV2BGR`` → ``BGR2GRAY`` → threshold, as
element-wise torch ops on tensors of any shape.  Each function computes
its formula as the JAX source writes it, one rounding an operation (where
PyTorch would round twice, :func:`ratio` and :func:`magnitude` say why),
so on the CPU it equals the JAX function run op by op bit for bit
(``tests/test_torch_colorspace_morph.py``).  Under ``jax.jit`` XLA may
fuse a product into an add or turn a division by a constant into a
product with its reciprocal, which moves some float32 results by an ulp;
so does PyTorch on the card for a division by a Python number.
"""

from __future__ import annotations

import math

import torch


def magnitude(fx: torch.Tensor, fy: torch.Tensor) -> torch.Tensor:
    """sqrt(fx² + fy²) in float32, the square root correctly rounded.
    PyTorch's vectorised float32 sqrt on the CPU is not always (one ulp off
    for ~0.7 % of inputs); the float64 root of a float32 value rounded to
    float32 is, on every device."""
    fx = fx.float()
    fy = fy.float()
    return torch.sqrt((fx * fx + fy * fy).double()).float()


def ratio(num: float, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` rounded once.  PyTorch evaluates ``number / tensor``
    as ``(1 / tensor) · number``, two roundings; a tensor numerator keeps
    the true division."""
    return torch.full_like(den, num) / den


def cart_to_polar(fx: torch.Tensor, fy: torch.Tensor):
    """Magnitude and angle (radians, [0, 2π)) of a flow field: the exact
    atan2, where ``cv2.cartToPolar`` uses its ~0.3° approximation."""
    mag = magnitude(fx, fy)
    ang = torch.atan2(fy.float(), fx.float())
    ang = torch.where(ang < 0, ang + 2.0 * math.pi, ang)
    return mag, ang


def normalize_minmax(x: torch.Tensor, lo: float = 0.0, hi: float = 255.0):
    """``cv2.normalize(x, None, lo, hi, cv2.NORM_MINMAX)`` over the whole
    tensor; a constant input maps to ``lo``."""
    x = x.float()
    mn = x.amin()
    mx = x.amax()
    scale = torch.where(mx - mn > 1e-12, ratio(hi - lo, mx - mn), 0.0)
    return (x - mn) * scale + lo


def saturate_u8(x: torch.Tensor) -> torch.Tensor:
    """OpenCV's ``saturate_cast<uchar>``: round half to even, then clamp."""
    return torch.round(x).clamp(0, 255).to(torch.uint8)


def trunc_u8(x: torch.Tensor) -> torch.Tensor:
    """Truncating cast to uint8 after the clamp (numpy's float → uint8
    assignment, which the reference relies on for hue and value)."""
    return torch.trunc(x).clamp(0, 255).to(torch.uint8)


def flow_to_hsv_u8(mag: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """The reference's HSV flow image ``[..., 3]``: H = ang·180/π/2
    truncated, S = 255, V = the min-max normalised magnitude truncated."""
    h = trunc_u8(ang * 180.0 / math.pi / 2.0)
    s = torch.full(mag.shape, 255, dtype=torch.uint8, device=mag.device)
    v = trunc_u8(normalize_minmax(mag, 0.0, 255.0))
    return torch.stack([h, s, v], dim=-1)


def _select(conds, vals, default):
    """``jnp.select``: the value of the first true condition, else
    ``default``."""
    out = default
    for cond, val in zip(reversed(conds), reversed(vals)):
        out = torch.where(cond, val, out)
    return out


def hsv_to_bgr_u8(hsv: torch.Tensor) -> torch.Tensor:
    """``cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)`` for uint8 ``[..., 3]``: H in
    [0, 180) in six sectors of 30, S and V in [0, 255]."""
    h = hsv[..., 0].float()
    s = hsv[..., 1].float() / 255.0
    v = hsv[..., 2].float()
    sector_f = h / 30.0
    sector = torch.floor(sector_f)
    f = sector_f - sector
    sector = sector.to(torch.int32) % 6
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    conds = [sector == i for i in range(5)]
    r = _select(conds, [v, q, p, p, t], v)
    g = _select(conds, [t, v, v, q, p], p)
    b = _select(conds, [p, p, t, v, v], q)
    return torch.stack([saturate_u8(b), saturate_u8(g), saturate_u8(r)], dim=-1)


def _gray(c0: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor, red_first: bool):
    r, g, b = (c0, c1, c2) if red_first else (c2, c1, c0)
    r, g, b = r.to(torch.int32), g.to(torch.int32), b.to(torch.int32)
    return ((r * 9798 + g * 19235 + b * 3735 + (1 << 14)) >> 15).to(torch.uint8)


def bgr_to_gray_u8(bgr: torch.Tensor) -> torch.Tensor:
    """``cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)`` with OpenCV's 15-bit
    fixed-point weights: (R·9798 + G·19235 + B·3735 + 2¹⁴) >> 15."""
    return _gray(bgr[..., 0], bgr[..., 1], bgr[..., 2], red_first=False)


def rgb_to_gray_u8(rgb: torch.Tensor) -> torch.Tensor:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)``: the same weights with
    channel 0 as R (the reference applies it to BGR frames)."""
    return _gray(rgb[..., 0], rgb[..., 1], rgb[..., 2], red_first=True)


def threshold_binary(x: torch.Tensor, thresh: float, maxval: float = 255.0):
    """``cv2.threshold(x, thresh, maxval, cv2.THRESH_BINARY)``: strictly
    greater than; maxval saturates to 255 (the reference passes 256)."""
    return torch.where(x > thresh, min(int(maxval), 255), 0).to(torch.uint8)
