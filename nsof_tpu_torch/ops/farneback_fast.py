"""Batched fast Farnebäck flow, every route, in PyTorch and CUDA.

Counterpart of :mod:`nsof_tpu.ops.farneback_fast`.  :func:`farneback_fast`
accepts every ``kernel_mode`` of the JAX package.

The fused route (``'fused'``, ``'fused_f32'``; ``_farneback_fast_fused``)
runs per pyramid level

- K2 :func:`poly_expansion` twice (prev and next), the five coefficient
  planes (b_y, b_x, a_yy, a_xx, a_xy); at level 0 with the 3-tap Gaussian
  pre-blur fused in;
- K3 :func:`update_matrices_sep` once, the level's first system M: warp the
  next frame's expansion r1 by the upscaled flow in two separable passes
  and build the five products, stored in bfloat16 (float32 for
  ``'fused_f32'``);
- K4 :func:`fused_box_update` ``iterations`` times: box-sum M, solve the
  2×2 system for the flow, and either rebuild M from it
  (``emit='matrices'``) or write the flow (``emit='flow'``, last one).

Its levels k ≥ 1 come from K12 :func:`pyramid_blur` (both images' reflect-101
pad and Gaussian blur in one launch, bit for bit the plain version's), then
a bilinear resize.

The level route (``'pallas_sep'``, ``'pallas'``, ``'xla'``;
``_farneback_fast_levels``) blurs the original frames for every level,
expands them and iterates a float32 system M on the level's own extent:

- K12 :func:`pyramid_blur` once, both frames' reflect-101 pad and blur,
  then a bilinear resize; the ``'xla'`` route runs the plain version
  :func:`_pyramid_blur_plain`;
- K11 :func:`poly_expansion_pair` once, both frames' expansions in tap
  order, bit for bit the plain version's; the ``'xla'`` route runs the
  plain version :func:`_poly_expansion_level_plain`;
- :func:`update_matrices` builds M: K5, the separable warp
  (``'pallas_sep'``), or K7, the (2r+2)²-tap warp (``'pallas'``); the
  ``'xla'`` route runs K7's plain version;
- :func:`box_solve` (K6) box-sums M and solves it for the flow; the
  ``'xla'`` route sums with :func:`_box_solve_dw` instead.

Layouts: frames ``[B, H, W]``, planes ``[B, 5, H, W]`` with W contiguous,
any B.  The JAX package's batch-in-lanes ``[H, W, B]`` layout and its
``B % 128 == 0`` gate are TPU constraints and are not carried over.

The fused route's logical canvas.  As in the JAX route, each level
computes on a canvas of ``hp = ceil(hk/32)·32`` by ``wp = ceil(wk/32)·32``
pixels, and pixels of the valid ``hk × wk`` region near its bottom and
right edges read what fills the slack:

- r0 and r1 are expansions of the *edge-extended* image (not
  edge-extended expansions); r1 carries a margin ring ``margin=(8, 16)``
  so the warp can read it outside the canvas;
- the flow read by K3 and the border scale are edge-extended from the
  valid region;
- M is edge-extended from the canvas, and K4's flow at the ±(radius+1)
  halo rows of a tile is solved from that extended M.

Every function here builds exactly that canvas, with the extents from 32,
whatever tile a CUDA kernel uses; the kernels read through clamped indices
instead of padded copies.

Each kernel wrapper runs its plain PyTorch version for a CPU tensor and
launches its CUDA kernel for a CUDA tensor, raising if it cannot.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from nsof_tpu_torch import _build
from nsof_tpu_torch.ops.farneback import (
    FarnebackParams,
    _blur_valid,
    _cv_round,
    _effective_levels,
    _extend,
    _gaussian_blur_kernel,
    _poly_exp_coeffs,
    _reflect_pad,
    _resize_hwb,
    _solve,
    _tap_sum,
    border_scale,
)
from nsof_tpu_torch.utils.timing import count, span

CANVAS = 32  # canvas granularity of the JAX route's tile grid
R1_MARGIN = (8, 16)  # r1's margin ring, rows and columns


# ── shared helpers ────────────────────────────────────────────────────────


def _hat(d: torch.Tensor, k: int) -> torch.Tensor:
    return (1.0 - (d - k).abs()).clamp(min=0.0)


def _check(t: torch.Tensor, name: str, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(
            f"{name}: expected {dtype} {tuple(shape)} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ── K2: polynomial expansion ──────────────────────────────────────────────


def _poly_expansion_plain(img, n, sigma, hp, wp, blur=None, margin=(0, 0)):
    """Plain version of K2 on the whole canvas (see :func:`poly_expansion`);
    the order of every sum is the Pallas kernel's."""
    g, xg, xxg, ig11, ig03, ig33, ig55 = _poly_exp_coeffs(n, sigma)
    b, hk, wk = img.shape
    mr, mc = margin
    nb = 0 if blur is None else len(blur) // 2
    hh = n + nb
    ho, wo = hp + 2 * mr, wp + 2 * mc
    src = _extend(img, mr + hh, hp - hk + mr + hh, mc + hh, wp - wk + mc + hh)
    if blur is not None:
        rows, cols = ho + 2 * n, wo + 2 * n
        v = None
        for s in range(2 * nb + 1):
            term = float(blur[s]) * src[:, s : s + rows, :]
            v = term if v is None else v + term
        hb = None
        for s in range(2 * nb + 1):
            term = float(blur[s]) * v[:, :, s : s + cols]
            hb = term if hb is None else hb + term
        src = hb  # [B, ho + 2n, wo + 2n]

    def vert(kern, odd):
        acc = None if odd else float(kern[n]) * src[:, n : n + ho]
        for t in range(1, n + 1):
            hi = src[:, n + t : n + t + ho]
            lo = src[:, n - t : n - t + ho]
            term = float(kern[n + t]) * ((hi - lo) if odd else (hi + lo))
            acc = term if acc is None else acc + term
        return acc

    def horiz(s, kern, odd):
        acc = None if odd else float(kern[n]) * s[:, :, n : n + wo]
        for t in range(1, n + 1):
            hi = s[:, :, n + t : n + t + wo]
            lo = s[:, :, n - t : n - t + wo]
            term = float(kern[n + t]) * ((hi - lo) if odd else (hi + lo))
            acc = term if acc is None else acc + term
        return acc

    s0, s1, s2 = vert(g, False), vert(xg, True), vert(xxg, False)
    b1 = horiz(s0, g, False)
    b2 = horiz(s1, g, False)
    b3 = horiz(s0, xg, True)
    b4 = horiz(s0, xxg, False)
    b5 = horiz(s2, g, False)
    b6 = horiz(s1, xg, True)
    return torch.stack(
        [b2 * ig11, b3 * ig11, b1 * ig03 + b5 * ig33, b1 * ig03 + b4 * ig33,
         b6 * ig55],
        dim=1,
    )


@functools.lru_cache(maxsize=64)
def _poly_coef_np(n, sigma, blur):
    """K2's coefficients, g, x·g, x²·g, the blur and the four scales, as one
    float32 array (the generic kernel reads them on the device, the
    template instances take them from the host as kernel parameters)."""
    g, xg, xxg, ig11, ig03, ig33, ig55 = _poly_exp_coeffs(n, sigma)
    vals = np.concatenate([g, xg, xxg, np.asarray(blur or (), np.float32),
                           np.asarray([ig11, ig03, ig33, ig55], np.float32)])
    return np.ascontiguousarray(vals, np.float32)


@functools.lru_cache(maxsize=64)
def _poly_coef_tensor(n, sigma, blur, device):
    return torch.from_numpy(_poly_coef_np(n, sigma, blur)).to(device)


def _poly_expansion_cuda(img, n, sigma, hp, wp, blur, margin):
    b, hk, wk = img.shape
    mr, mc = margin
    _check(img, "img", torch.float32, (b, hk, wk), img.device)
    blur_t = None if blur is None else tuple(float(v) for v in blur)
    coef = _poly_coef_tensor(n, float(sigma), blur_t, str(img.device))
    coef_host = _poly_coef_np(n, float(sigma), blur_t)
    n_blur = 0 if blur is None else len(blur)
    ho, wo = hp + 2 * mr, wp + 2 * mc
    out = torch.empty((b, 5, ho, wo), dtype=torch.float32, device=img.device)
    fn = _build.launcher("poly_expansion", 4, 9)
    _build.check(fn(
        img.data_ptr(), coef.data_ptr(), coef_host.ctypes.data, out.data_ptr(),
        b, hk, wk, n, n_blur, ho, wo, mr, mc, _stream(img),
    ), "poly_expansion")
    _build.LAUNCHES["poly_expansion"] += 1
    return out


def poly_expansion(img, n, sigma, hp, wp, blur=None, margin=(0, 0)):
    """K2: ``[B, hk, wk]`` float32 image → ``[B, 5, hp+2·mr, wp+2·mc]``
    expansion on the canvas.

    Canvas pixel (Y, X) holds the expansion of the edge-extended image at
    (Y − mr, X − mc).  ``blur`` (odd-length taps) pre-smooths the
    edge-extended image first, as the level-0 fused blur does.
    Counterpart of ``_poly_expansion_cm_pallas``.
    """
    if hp < img.shape[1] or wp < img.shape[2]:
        raise ValueError("canvas smaller than the image")
    if img.is_cuda:
        return _poly_expansion_cuda(img, n, sigma, hp, wp, blur, margin)
    return _poly_expansion_plain(img, n, sigma, hp, wp, blur, margin)


# ── K3 / K4 shared: separable warp + system build ─────────────────────────


def _build_system(r0, acc, dx, dy, bsc, out_dtype):
    """The five products of the system from r0, the warped r1 ``acc``, the
    clamped flow and the border scale, stored in ``out_dtype``."""
    r4 = (r0[:, 2] + acc[:, 2]) * 0.5
    r5 = (r0[:, 3] + acc[:, 3]) * 0.5
    r6 = (r0[:, 4] + acc[:, 4]) * 0.25
    b_y = (r0[:, 0] - acc[:, 0]) * 0.5
    b_x = (r0[:, 1] - acc[:, 1]) * 0.5
    r2 = b_y + r4 * dy + r6 * dx
    r3 = b_x + r6 * dy + r5 * dx
    r2, r3, r4, r5, r6 = (v * bsc for v in (r2, r3, r4, r5, r6))
    return torch.stack(
        [r4 * r4 + r6 * r6, (r4 + r5) * r6, r5 * r5 + r6 * r6,
         r4 * r2 + r6 * r3, r6 * r2 + r5 * r3],
        dim=1,
    ).to(out_dtype)


def _warp_build(r0, r1, dxh, dx, dy, bsc, radius, margin,
                out_dtype=torch.bfloat16):
    """Two-pass separable warp of r1 and the five products of the system,
    stored in ``out_dtype`` (the tail shared by K3, K4 and K5).

    ``dxh`` is the clamped dx on rows [-(r+1), hp+r+1) (pass 1 interpolates
    each row at its own dx), ``dx``/``dy`` the clamped flow and ``bsc`` the
    border scale on the canvas [hp, wp]."""
    b, _, hp, wp = r0.shape
    r = radius
    e = r + 1
    mr, mc = margin
    t = None
    for kx in range(-r, r + 2):
        tap = r1[:, :, mr - e : mr + hp + e, mc + kx : mc + kx + wp] * _hat(dxh, kx)[:, None]
        t = tap if t is None else t + tap
    acc = None
    for ky in range(-r, r + 2):
        tap = t[:, :, e + ky : e + ky + hp] * _hat(dy, ky)[:, None]
        acc = tap if acc is None else acc + tap
    return _build_system(r0, acc, dx, dy, bsc, out_dtype)


def _check_warp_operands(r0, r1, bsc, radius, margin):
    b, five, hp, wp = r0.shape
    mr, mc = margin
    if five != 5 or mr < radius + 1 or mc < radius + 1:
        raise ValueError(f"bad r0 {tuple(r0.shape)} / margin {margin}")
    _check(r0, "r0", torch.float32, (b, 5, hp, wp), r0.device)
    _check(r1, "r1", torch.float32, (b, 5, hp + 2 * mr, wp + 2 * mc), r0.device)
    _check(bsc, "bsc", torch.float32, bsc.shape, r0.device)
    if bsc.shape[0] > hp or bsc.shape[1] > wp:
        raise ValueError("border scale larger than the canvas")


# ── K3: the first system of a level ───────────────────────────────────────

M_DTYPES = (torch.bfloat16, torch.float32)
# the widest radius K3/K5's CUDA kernel takes: its tile of r1, pass 1's
# result and the flow must fit a block's shared memory
SEP_MAX_RADIUS = 37


def _update_matrices_sep_plain(dx, dy, r0, r1, bsc, radius, margin=R1_MARGIN,
                               out_dtype=torch.bfloat16):
    """Plain version of K3 (and K5) on the whole canvas."""
    _, _, hp, wp = r0.shape
    hk, wk = bsc.shape
    e = radius + 1
    dxh = _extend(dx, e, hp - hk + e, 0, wp - wk).clamp(-radius, radius)
    dyc = _extend(dy, 0, hp - hk, 0, wp - wk).clamp(-radius, radius)
    bscp = _extend(bsc, 0, hp - hk, 0, wp - wk)
    return _warp_build(r0, r1, dxh, dxh[:, e : e + hp], dyc, bscp, radius,
                       margin, out_dtype)


def _update_matrices_sep_cuda(dx, dy, r0, r1, bsc, radius, margin, out_dtype,
                              key):
    b, _, hp, wp = r0.shape
    hk, wk = bsc.shape
    _check_warp_operands(r0, r1, bsc, radius, margin)
    _check(dx, "dx", torch.float32, (b, hk, wk), r0.device)
    _check(dy, "dy", torch.float32, (b, hk, wk), r0.device)
    out = torch.empty((b, 5, hp, wp), dtype=out_dtype, device=r0.device)
    symbol = ("nsof_update_matrices_sep" if out_dtype == torch.bfloat16
              else "nsof_update_matrices_sep_f32")
    fn = _build.launcher("update_matrices_sep", 6, 8, symbol)
    _build.check(fn(
        dx.data_ptr(), dy.data_ptr(), r0.data_ptr(), r1.data_ptr(),
        bsc.data_ptr(), out.data_ptr(),
        b, hk, wk, hp, wp, margin[0], margin[1], radius, _stream(r0),
    ), key)
    _build.LAUNCHES[key] += 1
    return out


def update_matrices_sep(dx, dy, r0, r1, bsc, radius, margin=R1_MARGIN,
                        out_dtype=torch.bfloat16):
    """K3: the level's first system M ``[B, 5, hp, wp]`` in ``out_dtype``
    (bfloat16, or float32 for ``kernel_mode='fused_f32'``).

    ``dx``/``dy`` ``[B, hk, wk]`` the (unclamped) flow on the valid region,
    ``r0`` ``[B, 5, hp, wp]``, ``r1`` with its margin ring, ``bsc``
    ``[hk, wk]``.  Counterpart of ``_update_matrices_sep_cm``; the warp is
    the TPU kernel's two-pass one (pass 1 horizontal at each row's own dx,
    pass 2 vertical at the output pixel's dy), not a true 2-D bilinear warp.
    The CUDA kernel takes radius ≤ 37 (its tile of r1 must fit a block's
    shared memory) and raises beyond.
    """
    if out_dtype not in M_DTYPES:
        raise ValueError(f"out_dtype must be one of {M_DTYPES}, got {out_dtype}")
    if r0.is_cuda:
        key = ("update_matrices_sep" if out_dtype == torch.bfloat16
               else "update_matrices_sep_f32")
        return _update_matrices_sep_cuda(dx, dy, r0, r1, bsc, radius, margin,
                                         out_dtype, key)
    return _update_matrices_sep_plain(dx, dy, r0, r1, bsc, radius, margin,
                                      out_dtype)


# ── K4: one fused Farnebäck iteration ─────────────────────────────────────


def _win_sum_tree(a: torch.Tensor, n_out: int, win: int,
                  dim: int = -1) -> torch.Tensor:
    """out[i] = Σ_{t<win} a[i+t] along ``dim``, summed in the log-tree
    order of the TPU kernels' window sums (``_win_sum_tree``, and
    ``win_sum`` in ``_box_solve_kernel``)."""
    levels = [a]
    step = 1
    while step * 2 <= win:
        prev = levels[-1]
        ext = prev.shape[dim] - step
        levels.append(prev.narrow(dim, 0, ext) + prev.narrow(dim, step, ext))
        step *= 2
    out = None
    pos = 0
    for kbit in range(len(levels) - 1, -1, -1):
        if win & (1 << kbit):
            part = levels[kbit].narrow(dim, pos, n_out)
            out = part if out is None else out + part
            pos += 1 << kbit
    return out


def _blocks(x: torch.Tensor, rows: int, top: int, n_blk: int) -> torch.Tensor:
    """Split the row axis (dim 2) of ``[B, C, R, W]`` into ``n_blk``
    overlapping windows of ``rows`` rows starting at ``top + i·CANVAS``,
    folded into the batch: ``[B·n_blk, C, rows, W]``."""
    b, c, _, w = x.shape
    idx = (torch.arange(n_blk, device=x.device)[:, None] * CANVAS + top
           + torch.arange(rows, device=x.device)[None, :])
    out = x.index_select(2, idx.reshape(-1)).reshape(b, c, n_blk, rows, w)
    return out.transpose(1, 2).reshape(b * n_blk, c, rows, w)


def _fused_box_update_plain(m, r0, r1, bsc, winsize, radius, emit,
                            margin=R1_MARGIN):
    """Plain version of K4 on the whole canvas.

    The canvas is cut into blocks of 32 rows, the TPU kernel's row tile.
    The flow of a block's rows and its ±(radius+1) halo rows comes from a
    vertical window sum that runs down the block as a recurrence,
    S(r) = (S(r−1) + M(r+2m)) − M(r−1), started afresh at the block's first
    row, then a horizontal sum in log-tree order: the sums, and so their
    rounding, are the TPU kernel's.  A halo row's flow is solved
    separately by each block that reads it, as there."""
    b, _, hp, wp = m.shape
    mm = winsize // 2
    win = 2 * mm + 1
    e = radius + 1
    ext = e if emit == "matrices" else 0
    n_blk = hp // CANVAS
    rows = CANVAS + 2 * ext
    me = _extend(m.float(), ext + mm, ext + mm, mm, mm)
    slab = _blocks(me, rows + 2 * mm, 0, n_blk)  # [B·n, 5, rows+2m, wp+2m]
    s = slab[:, :, 0]
    for t in range(1, win):
        s = s + slab[:, :, t]
    vs = [s]
    for r in range(1, rows):
        s = s + slab[:, :, r + win - 1] - slab[:, :, r - 1]
        vs.append(s)
    v = torch.stack(vs, dim=2)
    g = _win_sum_tree(v, wp, win) * (1.0 / (winsize * winsize))
    fdx, fdy = _solve(g)  # [B·n, rows, wp]
    if emit == "flow":
        fl = torch.stack([fdx, fdy], dim=1).reshape(b, n_blk, 2, CANVAS, wp)
        return fl.transpose(1, 2).reshape(b, 2, hp, wp)
    hk, wk = bsc.shape
    mr, mc = margin
    dxh = fdx.clamp(-radius, radius)
    dyc = fdy[:, e : e + CANVAS].clamp(-radius, radius)
    bscp = _extend(bsc, 0, hp - hk, 0, wp - wk)[None, None]
    out = _warp_build(
        _blocks(r0, CANVAS, 0, n_blk),
        _blocks(r1, rows, mr - e, n_blk),
        dxh, dxh[:, e : e + CANVAS], dyc,
        _blocks(bscp, CANVAS, 0, n_blk)[:, 0].repeat(b, 1, 1),
        radius, (e, mc), m.dtype,
    )
    out = out.reshape(b, n_blk, 5, CANVAS, wp).transpose(1, 2)
    return out.reshape(b, 5, hp, wp)


# K4's strip design (csrc/fused_box_update.cu): a block owns a 32-column
# strip of one sample and walks down its 32-row blocks, the rows that
# consecutive blocks share kept in rings of shared memory and the next
# block's rows loaded while this one computes.  It has instances for the
# presets' windows (5, 15) at radius 3 and 5 (and the flow emit at any
# radius); the picker below takes it where two of its blocks fit an SM and
# chooses the walk from what it sees.  Every other case takes the tile
# design (one block a 32×32 tile, its phases in turn).
K4_SMEM_BYTES = 232448          # a block's dynamic shared memory on sm_90
K4_SM_SMEM_BYTES = 233472       # an SM's shared memory for its blocks
K4_BLOCK_SMEM_RESERVED = 1024   # the runtime's share of it a block
K4_STRIP_WINDOWS = (5, 15)
K4_STRIP_RADII = (3, 5)
K4_STRIP_THREADS = {"matrices": 320, "flow": 256}  # a strip block's threads
# the longest walk: on an H100 at grasp's canvases (B = 128) longer walks
# were slower, by 8 % for the flow emit at 34 row blocks against 4 (PERF.md §6)
K4_WALK_MAX = {"matrices": 9, "flow": 4}


class K4Plan(NamedTuple):
    """How one K4 launch runs: the strip design with each block walking
    ``walk`` 32-row blocks, M's ring of ``ring_m_rows`` rows and r1's of
    ``ring_r1_rows`` in ``smem`` bytes of shared memory; or, with ``walk``
    0, the tile design."""

    walk: int
    smem: int
    ring_m_rows: int
    ring_r1_rows: int


K4_TILE_PLAN = K4Plan(0, 0, 0, 0)


def _round16(n: int) -> int:
    return (n + 15) & ~15


def _k4_strip_layout(winsize: int, radius: int, emit_flow: bool, m_bytes: int) -> dict:
    """The strip design's shared memory (``csrc/fused_box_update.cu``'s
    ``Strip``, which this mirrors): M's ring of the slab's rows in M's type
    and r1's ring of the warp's rows, both in 16-byte chunks; the column
    sums (16-byte rows), then T in their room; the clamped flow."""
    mm = winsize // 2
    ext = 0 if emit_flow else radius + 1
    rows = CANVAS + 2 * ext
    slab_rows = rows + 2 * mm
    vc = CANVAS + 2 * mm
    a = 16 // m_bytes  # elements of a 16-byte copy
    mw = -(-(vc + (-mm) % a) // a) * a
    nr = CANVAS + 2 * radius + 1
    w1 = (CANVAS + ((radius + 3) & ~3) + radius + 1 + 3) & ~3  # from canvas column X0 - ⌈r⌉₄
    ring_r = 0 if emit_flow else _round16(nr * 5 * w1 * 4)
    sums = rows * 5 * ((vc + 3) & ~3) * 4
    tpass = 0 if emit_flow else nr * 5 * CANVAS * 4
    flow = 0 if emit_flow else (rows + CANVAS) * CANVAS * 4
    return {"bytes": _round16(slab_rows * 5 * mw * m_bytes) + ring_r
            + _round16(max(sums, tpass)) + flow,
            "ring_m_rows": slab_rows, "ring_r1_rows": 0 if emit_flow else nr, "align": a}


def k4_plan(winsize: int, radius: int, emit: str, m_dtype, hp: int, wp: int, b: int,
            n_sm: int) -> K4Plan:
    """How K4 runs on ``b`` canvases of ``hp × wp`` on a card of ``n_sm``
    SMs.  The strip design where it has an instance (``K4_STRIP_WINDOWS``,
    at ``K4_STRIP_RADII`` for the next system), two of its blocks fit an SM
    (float32 M's next system holds one: its phases would wait on each
    other) and the canvas width is a multiple of M's 16-byte copy.  Its
    walks are as long as ``K4_WALK_MAX`` allows and the walks of a strip
    balanced, but shorter where the grid would give the card's SMs fewer
    blocks than they hold, so a small canvas still fills the card.
    Otherwise the tile design."""
    if 2 * (winsize // 2) + 1 > 63:
        raise ValueError(f"winsize {winsize} exceeds the kernel's 63")
    flow = emit == "flow"
    lay = _k4_strip_layout(winsize, radius, flow, 2 if m_dtype == torch.bfloat16 else 4)
    per_sm = min(K4_SM_SMEM_BYTES // (lay["bytes"] + K4_BLOCK_SMEM_RESERVED),
                 2048 // K4_STRIP_THREADS[emit])
    if (2 * (winsize // 2) + 1 not in K4_STRIP_WINDOWS
            or not flow and radius not in K4_STRIP_RADII or per_sm < 2 or wp % lay["align"]):
        return K4_TILE_PLAN
    strips = -(-wp // CANVAS)
    blocks = hp // CANVAS
    n_walks = -(-blocks // K4_WALK_MAX[emit])
    while strips * b * n_walks < n_sm * per_sm and n_walks < blocks:
        n_walks += 1
    walk = -(-blocks // n_walks)
    return K4Plan(walk, lay["bytes"], lay["ring_m_rows"], lay["ring_r1_rows"])


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _fused_box_update_cuda(m, r0, r1, bsc, winsize, radius, emit, margin, plan=None):
    b, _, hp, wp = m.shape
    _check(m, "m", m.dtype, (b, 5, hp, wp), m.device)
    flow = emit == "flow"
    if plan is None:
        plan = k4_plan(winsize, radius, emit, m.dtype, hp, wp, b, _sm_count(m.device.index))
        # M's and r1's rows take 16-byte copies
        if m.data_ptr() % 16 or not flow and (r1.data_ptr() % 16 or margin[1] % 4):
            plan = K4_TILE_PLAN
    if flow:
        out = torch.empty((b, 2, hp, wp), dtype=torch.float32, device=m.device)
        hk, wk = bsc.shape
        # the flow emit reads neither r0, r1 nor the border scale
        r0_ptr = r1_ptr = bsc_ptr = 0
    else:
        _check_warp_operands(r0, r1, bsc, radius, margin)
        hk, wk = bsc.shape
        out = torch.empty((b, 5, hp, wp), dtype=m.dtype, device=m.device)
        r0_ptr, r1_ptr, bsc_ptr = r0.data_ptr(), r1.data_ptr(), bsc.data_ptr()
    key = "fused_box_update" if m.dtype == torch.bfloat16 else "fused_box_update_f32"
    fn = _build.launcher("fused_box_update", 5, 11, f"nsof_{key}")
    _build.check(fn(
        m.data_ptr(), r0_ptr, r1_ptr, bsc_ptr, out.data_ptr(),
        b, hk, wk, hp, wp, margin[0], margin[1], winsize, radius, int(flow), plan.walk,
        _stream(m),
    ), key)
    _build.LAUNCHES[key] += 1
    _build.LAUNCHES["fused_box_update_strip" if plan.walk else "fused_box_update_tile"] += 1
    return out


def fused_box_update(m, r0, r1, bsc, winsize, radius, emit, margin=R1_MARGIN):
    """K4: one Farnebäck iteration on the canvas.

    Box-sums the system ``m`` [B, 5, hp, wp] (bfloat16, or float32 for
    ``kernel_mode='fused_f32'``) over (2·(winsize//2)+1)² in float32
    (normalised by winsize²), solves the 2×2 system with +1e-3 on the
    determinant, then ``emit='matrices'``: rebuilds M′ (in m's dtype) from
    that flow as K3 does, with the flow of the ±(radius+1) halo rows solved
    from the edge-extended M; ``emit='flow'``: returns the float32 flow
    [B, 2, hp, wp].  Counterpart of ``_fused_box_update_cm``.
    """
    if emit not in ("matrices", "flow"):
        raise ValueError(f"emit must be 'matrices' or 'flow', got {emit!r}")
    if m.dtype not in M_DTYPES:
        raise ValueError(f"m must be one of {M_DTYPES}, got {m.dtype}")
    if m.shape[2] % CANVAS:
        raise ValueError(f"canvas height {m.shape[2]} is not a multiple of {CANVAS}")
    if m.is_cuda:
        return _fused_box_update_cuda(m, r0, r1, bsc, winsize, radius, emit,
                                      margin)
    return _fused_box_update_plain(m, r0, r1, bsc, winsize, radius, emit,
                                   margin)


# ── the level route: expansion, K5 / K7 update, K6 solve ──────────────────


# the widest n K11 takes: a tile's slab and sums must fit a block's shared
# memory (192 KB at n = 64)
LEVEL_MAX_N = 64


def _poly_expansion_level_plain(img: torch.Tensor, n: int, sigma: float,
                                pad: int = 0) -> torch.Tensor:
    """Plain version of K11: ``[B, H, W]`` image → ``[B, 5, H + 2·pad, W +
    2·pad]`` expansion (b_y, b_x, a_yy, a_xx, a_xy) of the edge-extended
    image, edge-extended by ``pad``.

    Counterpart of ``poly_expansion_fast`` / ``_poly_expansion_channels``,
    which the JAX package runs as XLA depthwise convolutions: three
    vertical (2n+1)-tap passes, then six horizontal ones on their
    edge-extended results, each summed in tap order."""
    g, xg, xxg, ig11, ig03, ig33, ig55 = _poly_exp_coeffs(n, sigma)
    h, w = img.shape[-2:]
    imgp = _extend(img, n, n, 0, 0)
    s0, s1, s2 = (_extend(_tap_sum(imgp, k, -2, h), 0, 0, n, n)
                  for k in (g, xg, xxg))
    b1 = _tap_sum(s0, g, -1, w)
    b2 = _tap_sum(s1, g, -1, w)
    b3 = _tap_sum(s0, xg, -1, w)
    b4 = _tap_sum(s0, xxg, -1, w)
    b5 = _tap_sum(s2, g, -1, w)
    b6 = _tap_sum(s1, xg, -1, w)
    out = torch.stack(
        [b2 * ig11, b3 * ig11, b1 * ig03 + b5 * ig33, b1 * ig03 + b4 * ig33,
         b6 * ig55],
        dim=1,
    )
    return _extend(out, pad, pad, pad, pad) if pad else out


def _poly_expansion_pair_plain(img0, img1, n: int, sigma: float, pad1: int):
    """Plain version of K11's two-image launch: r0 of ``img0`` and r1p of
    ``img1`` padded by ``pad1``."""
    return (_poly_expansion_level_plain(img0, n, sigma),
            _poly_expansion_level_plain(img1, n, sigma, pad1))


def _poly_expansion_level_cuda(imgs, n, sigma, pads):
    """K11 on one or two images of one shape in one launch, image i padded
    by ``pads[i]``."""
    b, h, w = imgs[0].shape
    for i, img in enumerate(imgs):
        _check(img, f"img{i}", torch.float32, (b, h, w), imgs[0].device)
    if not 1 <= n <= LEVEL_MAX_N:
        raise ValueError(f"poly_n {n} is outside K11's 1 … {LEVEL_MAX_N}")
    if min(pads) < 0:
        raise ValueError(f"pads {pads} must not be negative")
    coef = _poly_coef_tensor(n, float(sigma), None, str(imgs[0].device))
    coef_host = _poly_coef_np(n, float(sigma), None)
    outs = [torch.empty((b, 5, h + 2 * p, w + 2 * p), dtype=torch.float32,
                        device=imgs[0].device) for p in pads]
    img1, out1 = (imgs[1].data_ptr(), outs[1].data_ptr()) if len(imgs) == 2 else (0, 0)
    fn = _build.launcher("poly_expansion_level", 6, 7)
    _build.check(fn(
        imgs[0].data_ptr(), img1, coef.data_ptr(), coef_host.ctypes.data,
        outs[0].data_ptr(), out1, b, h, w, n, len(imgs), pads[0], pads[-1],
        _stream(imgs[0]),
    ), "poly_expansion_level")
    _build.LAUNCHES["poly_expansion_level"] += 1
    return outs


def poly_expansion_fast(img: torch.Tensor, n: int, sigma: float,
                        pad: int = 0) -> torch.Tensor:
    """K11: ``[B, H, W]`` float32 image → ``[B, 5, H + 2·pad, W + 2·pad]``
    expansion (b_y, b_x, a_yy, a_xx, a_xy) of the edge-extended image, on
    the image's own extent edge-extended by ``pad``: canvas pixel (Y, X)
    holds the expansion at (clamp(Y − pad), clamp(X − pad)).

    Bit for bit :func:`_poly_expansion_level_plain`, which a CPU tensor
    takes; a CUDA tensor launches K11 (``csrc/poly_expansion_level.cu``),
    which takes poly_n up to ``LEVEL_MAX_N`` and raises beyond."""
    if img.is_cuda:
        return _poly_expansion_level_cuda((img,), n, sigma, (pad,))[0]
    return _poly_expansion_level_plain(img, n, sigma, pad)


def poly_expansion_pair(img0: torch.Tensor, img1: torch.Tensor, n: int,
                        sigma: float, pad1: int):
    """A level's two expansions, r0 of ``img0`` and r1p of ``img1`` padded
    by ``pad1`` (:func:`poly_expansion_fast` of each), in one K11 launch on
    the card."""
    if img0.is_cuda:
        return tuple(_poly_expansion_level_cuda((img0, img1), n, sigma, (0, pad1)))
    return poly_expansion_fast(img0, n, sigma), poly_expansion_fast(img1, n, sigma, pad1)


def _pad_of(r0, r1p, radius):
    """The edge pad of ``r1p`` around ``r0``'s extent; raises unless it is
    even on both axes and covers the warp's reach of radius + 1."""
    b, five, h, w = r0.shape
    pad = (r1p.shape[-1] - w) // 2
    if (five != 5 or pad < radius + 1
            or tuple(r1p.shape) != (b, 5, h + 2 * pad, w + 2 * pad)):
        raise ValueError(f"r1p {tuple(r1p.shape)} is not r0 {tuple(r0.shape)} "
                         f"padded by radius + 1 = {radius + 1} or more")
    return pad


def _warp_full(dx, dy, r0, r1p, bsc, radius):
    """Plain version of K7, and the ``'xla'`` route's update (the JAX
    package's ``update_matrices_fast``): r1 sampled at (x + dx, y + dy) as
    the sum of its (2r+2)² hat-weighted taps, ky outer, kx inner,
    acc + tap·(wy·wx), then the system in float32."""
    _, _, h, w = r0.shape
    pad = _pad_of(r0, r1p, radius)
    dxc = dx.clamp(-radius, radius)
    dyc = dy.clamp(-radius, radius)
    acc = torch.zeros_like(r0)
    for ky in range(-radius, radius + 2):
        wy = _hat(dyc, ky)
        for kx in range(-radius, radius + 2):
            wgt = (wy * _hat(dxc, kx))[:, None]
            tap = r1p[:, :, pad + ky : pad + ky + h, pad + kx : pad + kx + w]
            acc = acc + tap * wgt
    return _build_system(r0, acc, dxc, dyc, bsc, torch.float32)


def _update_matrices_plain(dx, dy, r0, r1p, bsc, radius, separable=False):
    """Plain version of :func:`update_matrices`: K5's is K3's on the
    level's extent, K7's :func:`_warp_full`."""
    if separable:
        pad = _pad_of(r0, r1p, radius)
        return _update_matrices_sep_plain(dx, dy, r0, r1p, bsc, radius,
                                          (pad, pad), torch.float32)
    return _warp_full(dx, dy, r0, r1p, bsc, radius)


def _update_matrices_cuda(dx, dy, r0, r1p, bsc, radius, pad):
    b, _, h, w = r0.shape
    for name, t in (("dx", dx), ("dy", dy)):
        _check(t, name, torch.float32, (b, h, w), r0.device)
    _check(r0, "r0", torch.float32, (b, 5, h, w), r0.device)
    _check(r1p, "r1p", torch.float32, r1p.shape, r0.device)
    _check(bsc, "bsc", torch.float32, (h, w), r0.device)
    out = torch.empty((b, 5, h, w), dtype=torch.float32, device=r0.device)
    fn = _build.launcher("update_matrices", 6, 5)
    _build.check(fn(
        dx.data_ptr(), dy.data_ptr(), r0.data_ptr(), r1p.data_ptr(),
        bsc.data_ptr(), out.data_ptr(), b, h, w, pad, radius, _stream(r0),
    ), "update_matrices")
    _build.LAUNCHES["update_matrices"] += 1
    return out


def update_matrices(dx, dy, r0, r1p, bsc, radius, separable=False):
    """K5 (``separable=True``) or K7: the float32 system M ``[B, 5, H, W]``
    of a level of the level route.

    ``dx``/``dy`` ``[B, H, W]`` the (unclamped) flow, ``r0`` ``[B, 5, H,
    W]`` the first frame's expansion, ``r1p`` the second's, edge-padded by
    ``pad ≥ radius + 1`` on every side, ``bsc`` the ``[H, W]`` border
    scale.  Counterpart of ``update_matrices_pallas``: K5 is the two-pass
    separable warp (K3's kernel, in float32, on the level's own extent), K7
    the (2r+2)²-tap warp, bit for bit ``update_matrices_fast``
    (:func:`_warp_full`).  K7's CUDA kernel sums only the four taps whose
    hat weights can be non-zero, at floor(d) and floor(d) + 1 on each axis:
    every other tap adds ±0, so the sum is the same bit for bit
    (``csrc/update_matrices.cu`` says why).  K5's CUDA kernel takes radius
    ≤ 37 (its tile of r1 must fit a block's shared memory) and raises
    beyond; K7's takes any radius (the TPU kernels' halo of 8 allows r ≤ 7).
    """
    if not r0.is_cuda:
        return _update_matrices_plain(dx, dy, r0, r1p, bsc, radius, separable)
    pad = _pad_of(r0, r1p, radius)
    if separable:
        return _update_matrices_sep_cuda(
            dx, dy, r0, r1p, bsc, radius, (pad, pad), torch.float32,
            "update_matrices_sep_level")
    return _update_matrices_cuda(dx, dy, r0, r1p, bsc, radius, pad)


def _box_solve_plain(m: torch.Tensor, winsize: int):
    """Plain version of K6: the TPU kernel's window sum (each column of the
    window in log-tree order, then those column sums in the same order)
    over the edge-extended M, scaled, then solved."""
    _, _, h, w = m.shape
    mm = winsize // 2
    win = 2 * mm + 1
    me = _extend(m, mm, mm, mm, mm)
    g = _win_sum_tree(_win_sum_tree(me, h, win, dim=-2), w, win)
    return _solve(g * (1.0 / (winsize * winsize)))


def _box_solve_cuda(m: torch.Tensor, winsize: int):
    b, _, h, w = m.shape
    _check(m, "m", torch.float32, (b, 5, h, w), m.device)
    out = torch.empty((2, b, h, w), dtype=torch.float32, device=m.device)
    fn = _build.launcher("box_solve", 3, 4)
    _build.check(fn(
        m.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), b, h, w, winsize,
        _stream(m),
    ), "box_solve")
    _build.LAUNCHES["box_solve"] += 1
    return out[0], out[1]


def box_solve(m: torch.Tensor, winsize: int):
    """K6: float32 system ``[B, 5, H, W]`` → flow ``(dx, dy)``, each ``[B,
    H, W]`` float32: the (2·(winsize//2)+1)² box sum of M with edge
    replication, scaled by 1/winsize², and the 2×2 solve with +1e-3 on the
    determinant.  Counterpart of ``box_solve_pallas``, summed in its
    kernel's order at every winsize (the JAX driver leaves the kernel for
    ``_box_sum_dw`` when winsize//2 > 8)."""
    if m.is_cuda:
        return _box_solve_cuda(m, winsize)
    return _box_solve_plain(m, winsize)


def _box_solve_dw(m: torch.Tensor, winsize: int):
    """The ``'xla'`` route's solve (``update_flow_blur_fast`` without the
    Pallas kernel): the box sum of ``_box_sum_dw``, a vertical then a
    horizontal (2m+1)-tap sum with edge replication, scaled, then
    solved."""
    _, _, h, w = m.shape
    mm = winsize // 2
    ones = np.ones(2 * mm + 1, np.float32)
    v = _extend(_tap_sum(_extend(m, mm, mm, 0, 0), ones, -2, h), 0, 0, mm, mm)
    return _solve(_tap_sum(v, ones, -1, w) * (1.0 / (winsize * winsize)))


# ── K12: the pyramid's reflect-101 pad and blur ───────────────────────────


def _pyramid_blur_plain(img0: torch.Tensor, img1: torch.Tensor, k):
    """Plain version of K12: each ``[B, H, W]`` image reflect-101 padded by
    ``len(k) // 2`` and blurred by the separable taps ``k``, vertical pass
    first, each sum in tap order."""
    n = len(k) // 2
    return _blur_valid(_reflect_pad(img0, n), k), _blur_valid(_reflect_pad(img1, n), k)


def _blur_taps(img0: torch.Tensor, img1: torch.Tensor, k) -> np.ndarray:
    """``k`` as float32 taps, after checking what K12 takes: an odd number of
    taps, two contiguous float32 ``[B, H, W]`` images of one shape on one
    device, and n = len(k) // 2 below H and W (the reflect pad's own
    condition).  Raises ``ValueError`` otherwise."""
    taps = np.ascontiguousarray(k, np.float32)
    if taps.ndim != 1 or len(taps) % 2 == 0:
        raise ValueError(f"the blur takes an odd number of taps, got shape {taps.shape}")
    if img0.dim() != 3:
        raise ValueError(f"img0: expected [B, H, W], got {tuple(img0.shape)}")
    _check(img0, "img0", torch.float32, img0.shape, img0.device)
    _check(img1, "img1", torch.float32, img0.shape, img0.device)
    n = len(taps) // 2
    if n >= img0.shape[1] or n >= img0.shape[2]:
        raise ValueError(f"a reflect pad of {n} needs H and W above {n}, got "
                         f"{tuple(img0.shape[1:])}")
    return taps


@functools.lru_cache(maxsize=64)
def _taps_tensor(taps: tuple, device: str) -> torch.Tensor:
    return torch.tensor(taps, dtype=torch.float32, device=device)


def _pyramid_blur_cuda(img0: torch.Tensor, img1: torch.Tensor, taps: np.ndarray):
    b, h, w = img0.shape
    taps_dev = _taps_tensor(tuple(taps.tolist()), str(img0.device))
    out0, out1 = torch.empty_like(img0), torch.empty_like(img1)
    fn = _build.launcher("pyramid_blur", 6, 4)
    _build.check(fn(
        img0.data_ptr(), img1.data_ptr(), taps_dev.data_ptr(), taps.ctypes.data,
        out0.data_ptr(), out1.data_ptr(), b, h, w, len(taps), _stream(img0),
    ), "pyramid_blur")
    _build.LAUNCHES["pyramid_blur"] += 1
    return out0, out1


def pyramid_blur(img0: torch.Tensor, img1: torch.Tensor, k):
    """K12: a pyramid level's two ``[B, H, W]`` float32 images, each
    reflect-101 padded by n = len(k) // 2 and blurred by the odd-length
    separable taps ``k`` → two ``[B, H, W]`` planes.

    Bit for bit :func:`_pyramid_blur_plain`, which a CPU tensor takes; a
    CUDA tensor launches K12 (``csrc/pyramid_blur.cu``) once for both
    images.  Raises ``ValueError`` for an even number of taps, n ≥ H or W,
    or images that are not contiguous float32 of one shape on one device."""
    taps = _blur_taps(img0, img1, k)
    if img0.is_cuda:
        return _pyramid_blur_cuda(img0, img1, taps)
    return _pyramid_blur_plain(img0, img1, taps)


# ── pyramid glue ──────────────────────────────────────────────────────────


def _canvas(size: int) -> int:
    return -(-size // CANVAS) * CANVAS


def _farneback_fast_fused(img0, img1, params: FarnebackParams, radius: int,
                         m_dtype=torch.bfloat16):
    """The fused route on ``[B, H, W]`` float32 frames → (dx, dy)
    ``[B, H, W]``, the system M stored in ``m_dtype``.  Level k ≥ 1 images
    are built fine→coarse as a cascade: level 1 blurs the original (cv2's
    construction), deeper levels blur the previous level with the
    incremental sigma; K12 pads and blurs both images of a level, then each
    is resized."""
    b, h, w = img0.shape
    levels = _effective_levels(h, w, params.levels, params.pyr_scale)
    lvl_imgs = {}
    cur0, cur1 = img0, img1
    for k in range(1, levels + 1):
        scale = params.pyr_scale**k
        sigma_k = (1.0 / scale - 1.0) * 0.5
        wk_ = _cv_round(w * scale)
        hk_ = _cv_round(h * scale)
        if k == 1:
            sz = max(_cv_round(sigma_k * 5) | 1, 3)
            s_blur = sigma_k
        else:
            prev_scale = params.pyr_scale ** (k - 1)
            sigma_prev = (1.0 / prev_scale - 1.0) * 0.5
            tgt = sigma_k * prev_scale
            acc = sigma_prev * prev_scale
            s_blur = float(np.sqrt(max(tgt * tgt - acc * acc, 1e-12)))
            sz = max(2 * int(np.ceil(3.0 * s_blur)) + 1, 3)
        gk = _gaussian_blur_kernel(sz, s_blur)
        with span("nsof.farneback.pyramid"):
            cur0, cur1 = pyramid_blur(cur0, cur1, gk)
            cur0 = _resize_hwb(cur0, hk_, wk_)
            cur1 = _resize_hwb(cur1, hk_, wk_)
        lvl_imgs[k] = (cur0, cur1)

    dx = dy = None
    for k in range(levels, -1, -1):
        scale = params.pyr_scale**k
        sigma = (1.0 / scale - 1.0) * 0.5
        smooth_sz = max(_cv_round(sigma * 5) | 1, 3)
        wk = _cv_round(w * scale)
        hk = _cv_round(h * scale)
        hp, wp = _canvas(hk), _canvas(wk)
        if k == 0:
            # level 0 never resizes: its Gaussian is fused into K2
            i0, i1 = img0, img1
            blur = _gaussian_blur_kernel(smooth_sz, sigma)
        else:
            i0, i1 = lvl_imgs[k]
            blur = None
        with span("nsof.farneback.pyramid"):
            dx, dy = _upscale_flow(dx, dy, b, hk, wk, params.pyr_scale, img0.device)
        with span("nsof.farneback.expand"):
            r0 = poly_expansion(i0, params.poly_n, params.poly_sigma, hp, wp, blur)
            r1 = poly_expansion(i1, params.poly_n, params.poly_sigma, hp, wp, blur,
                                margin=R1_MARGIN)
        with span("nsof.farneback.update"):
            bsc = border_scale(hk, wk, str(img0.device))
            m = update_matrices_sep(dx, dy, r0, r1, bsc, radius, out_dtype=m_dtype)
            for _ in range(params.iterations - 1):
                m = fused_box_update(m, r0, r1, bsc, params.winsize, radius,
                                     "matrices")
            fl = fused_box_update(m, r0, r1, bsc, params.winsize, radius, "flow")
        dx = fl[:, 0, :hk, :wk]
        dy = fl[:, 1, :hk, :wk]
    return dx, dy


def _upscale_flow(dx, dy, b, hk, wk, pyr_scale, device):
    """The flow carried into a level of ``hk × wk``: zeros at the coarsest
    level, else the coarser level's flow resized and scaled by
    1/pyr_scale."""
    if dx is None:
        zero = torch.zeros((b, hk, wk), dtype=torch.float32, device=device)
        return zero, zero
    return (_resize_hwb(dx, hk, wk) * (1.0 / pyr_scale),
            _resize_hwb(dy, hk, wk) * (1.0 / pyr_scale))


def _farneback_fast_levels(img0, img1, params: FarnebackParams, radius: int,
                           kernel_mode: str):
    """The level route (``kernel_mode`` 'pallas_sep', 'pallas' or 'xla')
    on ``[B, H, W]`` float32 frames → (dx, dy) ``[B, H, W]``.

    Every level blurs the original frames with its own sigma (reflect-101
    pad and blur, K12 once a level, then resize), expands both (r1 padded
    by radius + 1; K11 once a level), and iterates the float32 system: one
    update, then ``iterations`` × (solve, and update for all but the last).
    The ``'xla'`` route runs the plain versions of K11 and K12."""
    b, h, w = img0.shape
    e = radius + 1
    if kernel_mode == "xla":
        blur = _pyramid_blur_plain

        def expand(i0, i1):
            return _poly_expansion_pair_plain(i0, i1, params.poly_n, params.poly_sigma, e)

        def update(dx, dy, r0, r1p, bsc):
            return _warp_full(dx, dy, r0, r1p, bsc, radius)

        def solve(m):
            return _box_solve_dw(m, params.winsize)
    else:
        sep = kernel_mode == "pallas_sep"
        blur = pyramid_blur

        def expand(i0, i1):
            return poly_expansion_pair(i0, i1, params.poly_n, params.poly_sigma, e)

        def update(dx, dy, r0, r1p, bsc):
            return update_matrices(dx, dy, r0, r1p, bsc, radius, separable=sep)

        def solve(m):
            return box_solve(m, params.winsize)

    levels = _effective_levels(h, w, params.levels, params.pyr_scale)
    dx = dy = None
    for k in range(levels, -1, -1):
        scale = params.pyr_scale**k
        sigma = (1.0 / scale - 1.0) * 0.5
        smooth_sz = max(_cv_round(sigma * 5) | 1, 3)
        wk = _cv_round(w * scale)
        hk = _cv_round(h * scale)
        gk = _gaussian_blur_kernel(smooth_sz, sigma)
        with span("nsof.farneback.pyramid"):
            dx, dy = _upscale_flow(dx, dy, b, hk, wk, params.pyr_scale, img0.device)
            i0, i1 = blur(img0, img1, gk)
            i0 = _resize_hwb(i0, hk, wk)
            i1 = _resize_hwb(i1, hk, wk)
        with span("nsof.farneback.expand"):
            r0, r1p = expand(i0, i1)
        with span("nsof.farneback.update"):
            bsc = border_scale(hk, wk, str(img0.device))
            m = update(dx, dy, r0, r1p, bsc)
            for i in range(params.iterations):
                dx, dy = solve(m)
                if i < params.iterations - 1:
                    m = update(dx, dy, r0, r1p, bsc)
    return dx, dy


KERNEL_MODES = ("auto", "fused", "fused_f32", "pallas_sep", "pallas", "xla")


def route(kernel_mode: str, params: FarnebackParams) -> str:
    """The route ``kernel_mode`` runs, as the JAX package picks it on the
    TPU: 'auto' is 'fused'; the fused routes fall back to 'pallas_sep' for
    presets beyond their halos (winsize//2 > 8 or poly_n > 7).  Unlike the
    JAX package, no route depends on the batch size."""
    if kernel_mode not in KERNEL_MODES:
        raise ValueError(f"kernel_mode must be one of {KERNEL_MODES}, "
                         f"got {kernel_mode!r}")
    if kernel_mode == "auto":
        kernel_mode = "fused"
    if kernel_mode in ("fused", "fused_f32") and (
            params.winsize // 2 > 8 or params.poly_n > 7):
        return "pallas_sep"
    return kernel_mode


def farneback_fast(
    prev,
    next_,
    params: FarnebackParams = FarnebackParams(),
    warp_radius: int = 4,
    kernel_mode: str = "auto",
    out_layout: str = "bhw2",
    device=None,
):
    """Batched dense flow: ``[B, H, W]`` uint8/float pairs → ``[B, H, W, 2]``
    float32 (``out_layout='bhw2'``) or the planes ``(dx, dy)``, each
    ``[B, H, W]`` (``'planes'``; the JAX package's planes are
    ``[H, W, B]``).

    Runs on ``device`` (default: the CUDA device; raises ``RuntimeError``
    when there is none — pass ``device='cpu'`` for the plain versions).
    ``kernel_mode``: 'fused' (K2–K4, M in bfloat16), 'fused_f32' (M in
    float32), 'pallas_sep' (K5 + K6), 'pallas' (K7 + K6), 'xla' (plain
    torch), or 'auto', routed as :func:`route` says.  Every route takes any
    batch size.
    """
    kernel_mode = route(kernel_mode, params)
    dev = _build.resolve_device(device)
    with span("nsof.farneback"):
        img0 = torch.as_tensor(prev).to(dev, torch.float32).contiguous()
        img1 = torch.as_tensor(next_).to(dev, torch.float32).contiguous()
        count("nsof.flow", rows=img0.shape[0], px=img0.shape[1] * img0.shape[2])
        if kernel_mode in ("fused", "fused_f32"):
            m_dtype = torch.bfloat16 if kernel_mode == "fused" else torch.float32
            dx, dy = _farneback_fast_fused(img0, img1, params, warp_radius, m_dtype)
        else:
            dx, dy = _farneback_fast_levels(img0, img1, params, warp_radius,
                                            kernel_mode)
        if out_layout == "planes":
            return dx, dy
        return torch.stack([dx, dy], dim=-1)
