"""Farnebäck parameters, shared tensor helpers and the exact path.

The PyTorch port's counterpart of :mod:`nsof_tpu.ops.farneback`:

- the parameter dataclass and presets, the polynomial-expansion basis
  (OpenCV's FarnebackPrepareGaussian), the border attenuation table,
  cvRound, cv2.getGaussianKernel and the pyramid-depth clip, bit-identical
  to the JAX package's (held by ``tests/test_torch_config.py``);
- the shift helpers that the fast route (:mod:`.farneback_fast`) shares
  with the exact path: edge extension, weighted sums of shifted slices,
  reflect-101 padding, the bilinear resize, the border scale and the 2×2
  solve;
- the exact OpenCV-semantics path, :func:`farneback` and
  :func:`farneback_batch`: the same algorithm as the JAX package's, batched
  over a leading ``B``.  Every convolution is a weighted sum of shifted
  slices, so no TF32 or cuDNN algorithm choice enters on the card; the
  sums run in tap order, where XLA's convolutions pick their own order, so
  the flow agrees with the JAX package's to float32 rounding grown through
  the iterations (``tests/test_torch_farneback_exact.py`` holds it).

Layouts: images ``[B, H, W]``, expansions and systems ``[B, 5, H, W]``
(channels b_y, b_x, a_yy, a_xx, a_xy and g11, g12, g22, h1, h2), flow
``[B, H, W, 2]`` with (dx, dy) channels.  The exact path launches no
kernel of the port.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from nsof_tpu_torch import _build


@dataclasses.dataclass(frozen=True)
class FarnebackParams:
    """Mirror of the cv2 parameter dict (optical_flow_seg.py:73-81)."""

    pyr_scale: float = 0.5
    levels: int = 3
    winsize: int = 15
    iterations: int = 3
    poly_n: int = 5
    poly_sigma: float = 1.2


PRESETS = {
    "grasp": FarnebackParams(0.5, 3, 15, 3, 5, 1.2),
    "uavnew2": FarnebackParams(0.5, 3, 15, 3, 5, 1.2),
    "tabletennis": FarnebackParams(0.6, 3, 4, 2, 1, 1.05),
    "autodriving": FarnebackParams(0.6, 3, 3, 3, 10, 1.05),
    "uav": FarnebackParams(0.6, 3, 3, 3, 10, 1.05),
}


@functools.lru_cache(maxsize=None)
def _poly_exp_coeffs(n: int, sigma: float):
    """Gaussian basis kernels g, x·g, x²·g (Σg = 1) and the entries (1,1),
    (0,3), (3,3), (5,5) of the inverse 6×6 moment matrix for the basis
    (1, x, y, x², y², xy) — OpenCV's FarnebackPrepareGaussian."""
    if sigma < 1.19209290e-07:
        sigma = n * 0.3
    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    g /= g.sum()
    xg = x * g
    xxg = x * x * g

    m2 = float((g * x * x).sum())
    m4 = float((g * x**4).sum())
    moments = np.zeros((6, 6))
    moments[0, 0] = 1.0
    moments[1, 1] = moments[2, 2] = m2
    moments[0, 3] = moments[0, 4] = moments[3, 0] = moments[4, 0] = m2
    moments[3, 3] = moments[4, 4] = m4
    moments[3, 4] = moments[4, 3] = m2 * m2
    moments[5, 5] = m2 * m2
    inv = np.linalg.inv(moments)
    return (
        g.astype(np.float32),
        xg.astype(np.float32),
        xxg.astype(np.float32),
        float(inv[1, 1]),
        float(inv[0, 3]),
        float(inv[3, 3]),
        float(inv[5, 5]),
    )


# OpenCV's border[] attenuation table for the update matrices
_BORDER_TABLE = np.array([0.14, 0.14, 0.4472, 0.4472, 0.4472], np.float32)
_BORDER = 5


def _cv_round(v: float) -> int:
    """cvRound: round half to even (C rint)."""
    f = math.floor(v)
    diff = v - f
    if diff > 0.5:
        return f + 1
    if diff < 0.5:
        return f
    return f + (f % 2)


def _gaussian_blur_kernel(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel semantics, including the fixed small kernels
    when sigma <= 0."""
    if sigma <= 0:
        fixed = {
            1: [1.0],
            3: [0.25, 0.5, 0.25],
            5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
            7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375,
                0.03125],
        }
        if ksize in fixed:
            return np.asarray(fixed[ksize], np.float32)
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    k /= k.sum()
    return k.astype(np.float32)


def _effective_levels(h: int, w: int, levels: int, pyr_scale: float) -> int:
    """OpenCV clips pyramid depth so no level goes below 32 px."""
    min_size = 32
    k = 0
    scale = 1.0
    while k < levels:
        scale *= pyr_scale
        if w * scale < min_size or h * scale < min_size:
            break
        k += 1
    return k


# ── shift helpers shared with the fast route ─────────────────────────────


def _extend(x: torch.Tensor, top: int, bottom: int, left: int, right: int):
    """Edge-extend the last two dims: rows [-top, H+bottom), cols
    [-left, W+right), each read at the clamped index."""
    h, w = x.shape[-2:]
    rows = torch.arange(-top, h + bottom, device=x.device).clamp_(0, h - 1)
    cols = torch.arange(-left, w + right, device=x.device).clamp_(0, w - 1)
    return x.index_select(-2, rows).index_select(-1, cols)


@functools.lru_cache(maxsize=None)
def _border_scale_np(h: int, w: int) -> np.ndarray:
    def axis_scale(size):
        s = np.ones(size, np.float32)
        for i in range(min(_BORDER, size)):
            s[i] *= _BORDER_TABLE[i]
            s[size - 1 - i] *= _BORDER_TABLE[i]
        return s

    return np.outer(axis_scale(h), axis_scale(w))


@functools.lru_cache(maxsize=64)
def border_scale(h: int, w: int, device: str) -> torch.Tensor:
    """OpenCV's border attenuation as an ``[h, w]`` float32 tensor."""
    return torch.from_numpy(_border_scale_np(h, w)).to(device)


def _solve(g: torch.Tensor):
    """The 2×2 solve of the box-summed system ``g`` ``[..., 5, H, W]``
    (channel dim 1), +1e-3 on the determinant → (dx, dy)."""
    g11, g12, g22, h1, h2 = g.unbind(1)
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    return (g11 * h2 - g12 * h1) * idet, (g22 * h1 - g12 * h2) * idet


def _tap_sum(x: torch.Tensor, k: np.ndarray, dim: int, n_out: int):
    """Σ_t k[t]·x[t : t + n_out] along ``dim`` (a valid-mode correlation),
    as weighted sums of shifted slices: no convolution, so no TF32 on the
    card."""
    out = float(k[0]) * x.narrow(dim, 0, n_out)
    for t in range(1, len(k)):
        out.add_(x.narrow(dim, t, n_out), alpha=float(k[t]))
    return out


def _blur_valid(xp: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    """Separable valid-mode blur of a pre-padded ``[B, H+2n, W+2n]``
    image, as weighted sums of shifted slices (no convolution, so no TF32
    on the card)."""
    taps = len(k)
    rows = xp.shape[-2] - taps + 1
    cols = xp.shape[-1] - taps + 1
    v = None
    for s in range(taps):
        term = float(k[s]) * xp[..., s : s + rows, :]
        v = term if v is None else v + term
    out = None
    for s in range(taps):
        term = float(k[s]) * v[..., s : s + cols]
        out = term if out is None else out + term
    return out


def _reflect_pad(x: torch.Tensor, n: int) -> torch.Tensor:
    """Reflect-101 padding (OpenCV's BORDER_DEFAULT) of ``[B, H, W]``."""
    return F.pad(x[:, None], (n, n, n, n), mode="reflect")[:, 0]


def _resize_hwb(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of ``[B, H, W]``: half-pixel centres, no antialias
    (``jax.image.resize(..., 'bilinear', antialias=False)``)."""
    if tuple(img.shape[-2:]) == (out_h, out_w):
        return img
    return F.interpolate(img[:, None], size=(out_h, out_w), mode="bilinear",
                         align_corners=False, antialias=False)[:, 0]


# ── the exact path ────────────────────────────────────────────────────────


def _conv1d(img: torch.Tensor, kernel: np.ndarray, dim: int) -> torch.Tensor:
    """Correlate ``[..., H, W]`` along ``dim`` (-2 rows, -1 columns) with
    edge padding (the JAX package's ``_conv1d``)."""
    n = len(kernel) // 2
    pad = (n, n, 0, 0) if dim == -2 else (0, 0, n, n)
    return _tap_sum(_extend(img, *pad), kernel, dim, img.shape[dim])


def poly_expansion(img: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    """Quadratic polynomial expansion of ``[B, H, W]`` float images →
    ``[B, 5, H, W]`` (b_y, b_x, a_yy, a_xx, a_xy), OpenCV's FarnebackPolyExp
    with its two-term shortcut for the quadratic coefficients."""
    g, xg, xxg, ig11, ig03, ig33, ig55 = _poly_exp_coeffs(n, sigma)
    img = img.float()
    s0, s1, s2 = (_conv1d(img, k, -2) for k in (g, xg, xxg))
    b1 = _conv1d(s0, g, -1)
    b2 = _conv1d(s1, g, -1)
    b3 = _conv1d(s0, xg, -1)
    b4 = _conv1d(s0, xxg, -1)
    b5 = _conv1d(s2, g, -1)
    b6 = _conv1d(s1, xg, -1)
    return torch.stack(
        [b2 * ig11, b3 * ig11, b1 * ig03 + b5 * ig33, b1 * ig03 + b4 * ig33,
         b6 * ig55],
        dim=1,
    )


def _sample_r1(r1: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor):
    """Bilinear sample of the ``[B, 5, H, W]`` expansion at the float
    coordinates ``[B, H, W]``, read at clamped indices, and the in-bounds
    mask of OpenCV's rule: the sample counts only where its 2×2 cell lies
    inside the image."""
    b, c, h, w = r1.shape
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    inb = (x0 >= 0) & (x0 < w - 1) & (y0 >= 0) & (y0 < h - 1)
    ax = fx - x0
    ay = fy - y0
    x0i = x0.long().clamp(0, w - 1)
    y0i = y0.long().clamp(0, h - 1)
    x1i = (x0i + 1).clamp(0, w - 1)
    y1i = (y0i + 1).clamp(0, h - 1)
    flat = r1.reshape(b, c, h * w)

    def tap(yi, xi):
        idx = (yi * w + xi).reshape(b, 1, h * w).expand(b, c, h * w)
        return flat.gather(2, idx).reshape(b, c, h, w)

    samp = (tap(y0i, x0i) * ((1 - ax) * (1 - ay))[:, None]
            + tap(y0i, x1i) * (ax * (1 - ay))[:, None]
            + tap(y1i, x0i) * ((1 - ax) * ay)[:, None]
            + tap(y1i, x1i) * (ax * ay)[:, None])
    return samp, inb


def update_matrices(r0: torch.Tensor, r1: torch.Tensor, dx: torch.Tensor,
                    dy: torch.Tensor) -> torch.Tensor:
    """The system M ``[B, 5, H, W]`` from the expansions of both frames and
    the current flow (OpenCV's FarnebackUpdateMatrices): r1 sampled at
    (x + dx, y + dy); out of bounds, the b-difference is zeroed and the
    cross term halved."""
    _, _, h, w = r0.shape
    xs = torch.arange(w, dtype=torch.float32, device=r0.device)
    ys = torch.arange(h, dtype=torch.float32, device=r0.device)[:, None]
    samp, inb = _sample_r1(r1, xs + dx, ys + dy)
    r4 = torch.where(inb, (r0[:, 2] + samp[:, 2]) * 0.5, r0[:, 2])
    r5 = torch.where(inb, (r0[:, 3] + samp[:, 3]) * 0.5, r0[:, 3])
    r6 = torch.where(inb, (r0[:, 4] + samp[:, 4]) * 0.25, r0[:, 4] * 0.5)
    zero = torch.zeros((), dtype=torch.float32, device=r0.device)
    b_y = torch.where(inb, (r0[:, 0] - samp[:, 0]) * 0.5, zero)
    b_x = torch.where(inb, (r0[:, 1] - samp[:, 1]) * 0.5, zero)
    r2 = b_y + r4 * dy + r6 * dx
    r3 = b_x + r6 * dy + r5 * dx
    bsc = border_scale(h, w, str(r0.device))
    r2, r3, r4, r5, r6 = (v * bsc for v in (r2, r3, r4, r5, r6))
    return torch.stack(
        [r4 * r4 + r6 * r6, (r4 + r5) * r6, r5 * r5 + r6 * r6,
         r4 * r2 + r6 * r3, r6 * r2 + r5 * r3],
        dim=1,
    )


def _box_sum(x: torch.Tensor, m: int) -> torch.Tensor:
    """(2m+1)² box sum of ``[..., H, W]`` with edge padding, rows first."""
    ones = np.ones(2 * m + 1, np.float32)
    return _conv1d(_conv1d(x, ones, -2), ones, -1)


def update_flow_blur(r0, r1, m, winsize: int, update_mats: bool):
    """One box-filter solve (OpenCV's FarnebackUpdateFlow_Blur): box-sum M
    over (2·(winsize//2)+1)², normalised by winsize², solve the 2×2 system
    with +1e-3 on the determinant, and rebuild M from the new flow unless
    this is the last iteration.  Returns (dx, dy, M)."""
    g = _box_sum(m, winsize // 2) * (1.0 / (winsize * winsize))
    dx, dy = _solve(g)
    if update_mats:
        m = update_matrices(r0, r1, dx, dy)
    return dx, dy, m


def _gaussian_blur(img: torch.Tensor, ksize: int, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of ``[B, H, W]`` with reflect-101 borders
    (OpenCV's BORDER_DEFAULT)."""
    return _blur_valid(_reflect_pad(img, ksize // 2),
                       _gaussian_blur_kernel(ksize, sigma))


def farneback_batch(prev, next_, params: FarnebackParams = FarnebackParams(),
                    device=None) -> torch.Tensor:
    """Dense flow between ``[B, H, W]`` grayscale frame stacks (uint8 or
    float, tensors or numpy arrays) → ``[B, H, W, 2]`` float32 (dx, dy),
    the JAX package's ``farneback`` on each pair, computed as one batch.

    Equivalent of ``cv2.calcOpticalFlowFarneback(prev, next, None,
    pyr_scale, levels, winsize, iterations, poly_n, poly_sigma, 0)``.  Runs
    on ``device``; by default the CUDA device, raising ``RuntimeError`` when
    there is none (``device='cpu'`` runs on the CPU).
    """
    dev = _build.resolve_device(device)
    img0 = torch.as_tensor(prev).to(dev, torch.float32)
    img1 = torch.as_tensor(next_).to(dev, torch.float32)
    b, h, w = img0.shape
    levels = _effective_levels(h, w, params.levels, params.pyr_scale)
    dx = dy = None
    for k in range(levels, -1, -1):
        scale = params.pyr_scale**k
        sigma = (1.0 / scale - 1.0) * 0.5
        smooth_sz = max(_cv_round(sigma * 5) | 1, 3)
        wk = _cv_round(w * scale)
        hk = _cv_round(h * scale)
        if dx is None:
            dx = dy = torch.zeros((b, hk, wk), dtype=torch.float32, device=dev)
        else:
            dx = _resize_hwb(dx, hk, wk) * (1.0 / params.pyr_scale)
            dy = _resize_hwb(dy, hk, wk) * (1.0 / params.pyr_scale)
        i0 = _resize_hwb(_gaussian_blur(img0, smooth_sz, sigma), hk, wk)
        i1 = _resize_hwb(_gaussian_blur(img1, smooth_sz, sigma), hk, wk)
        r0 = poly_expansion(i0, params.poly_n, params.poly_sigma)
        r1 = poly_expansion(i1, params.poly_n, params.poly_sigma)
        m = update_matrices(r0, r1, dx, dy)
        for i in range(params.iterations):
            dx, dy, m = update_flow_blur(r0, r1, m, params.winsize,
                                         update_mats=i < params.iterations - 1)
    return torch.stack([dx, dy], dim=-1)


def farneback(prev, next_, params: FarnebackParams = FarnebackParams(),
              device=None) -> torch.Tensor:
    """Dense flow between two ``[H, W]`` grayscale frames → ``[H, W, 2]``
    float32 (:func:`farneback_batch` on a batch of one)."""
    return farneback_batch(torch.as_tensor(prev)[None],
                           torch.as_tensor(next_)[None], params, device)[0]
