"""The plain fast Farnebäck flow, both routes, as the benchmark's reference.

A frozen copy of the port's plain routes (the CPU versions of K2–K7 and the
pyramid glue around them): the fused route (``'fused'``: M stored in
bfloat16) and the level route (``'pallas_sep'``: M in float32).  It imports
nothing of the port: every helper it needs is restated here, so that a
change to the port cannot move the yardstick.  Every sum runs in the
port's order and every operation rounds once, so on one device the port's
kernels give these bits (the level route's box sum, K6, to about 1e-5 px).

``dt`` is the precision of the arithmetic and ``m_dt`` the precision M is
stored in.  The reference runs at float32 (M in bfloat16 on the fused
route, float32 on the level route); the control runs the same code one
precision lower (``dt=bfloat16``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

CANVAS = 32  # canvas granularity of the fused route's tile grid
R1_MARGIN = (8, 16)  # r1's margin ring on the fused route, rows and columns
_BORDER_TABLE = np.array([0.14, 0.14, 0.4472, 0.4472, 0.4472], np.float32)


# ── constants of the method (OpenCV's) ───────────────────────────────────


def poly_exp_coeffs(n: int, sigma: float):
    """OpenCV's FarnebackPrepareGaussian: g, x·g, x²·g (Σg = 1) and the
    entries (1,1), (0,3), (3,3), (5,5) of the inverse moment matrix."""
    if sigma < 1.19209290e-07:
        sigma = n * 0.3
    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    g /= g.sum()
    xg = x * g
    xxg = x * x * g
    m2 = float((g * x * x).sum())
    m4 = float((g * x**4).sum())
    mom = np.zeros((6, 6))
    mom[0, 0] = 1.0
    mom[1, 1] = mom[2, 2] = m2
    mom[0, 3] = mom[0, 4] = mom[3, 0] = mom[4, 0] = m2
    mom[3, 3] = mom[4, 4] = m4
    mom[3, 4] = mom[4, 3] = m2 * m2
    mom[5, 5] = m2 * m2
    inv = np.linalg.inv(mom)
    return (g.astype(np.float32), xg.astype(np.float32), xxg.astype(np.float32),
            float(inv[1, 1]), float(inv[0, 3]), float(inv[3, 3]), float(inv[5, 5]))


def cv_round(v: float) -> int:
    """cvRound: round half to even."""
    f = math.floor(v)
    diff = v - f
    if diff > 0.5:
        return f + 1
    if diff < 0.5:
        return f
    return f + (f % 2)


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel, with its fixed small kernels for sigma <= 0."""
    if sigma <= 0:
        fixed = {1: [1.0], 3: [0.25, 0.5, 0.25],
                 5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
                 7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125]}
        if ksize in fixed:
            return np.asarray(fixed[ksize], np.float32)
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    k /= k.sum()
    return k.astype(np.float32)


def effective_levels(h: int, w: int, levels: int, pyr_scale: float) -> int:
    """OpenCV's pyramid depth: no level below 32 px."""
    k, scale = 0, 1.0
    while k < levels:
        scale *= pyr_scale
        if w * scale < 32 or h * scale < 32:
            break
        k += 1
    return k


def border_scale(h: int, w: int, dt, device) -> torch.Tensor:
    """OpenCV's border attenuation of the update matrices, ``[h, w]``."""
    def axis(size):
        s = np.ones(size, np.float32)
        for i in range(min(5, size)):
            s[i] *= _BORDER_TABLE[i]
            s[size - 1 - i] *= _BORDER_TABLE[i]
        return s

    return torch.from_numpy(np.outer(axis(h), axis(w))).to(device, dt)


# ── shift helpers ─────────────────────────────────────────────────────────


def extend(x: torch.Tensor, top: int, bottom: int, left: int, right: int):
    """Edge-extend the last two dims."""
    h, w = x.shape[-2:]
    rows = torch.arange(-top, h + bottom, device=x.device).clamp_(0, h - 1)
    cols = torch.arange(-left, w + right, device=x.device).clamp_(0, w - 1)
    return x.index_select(-2, rows).index_select(-1, cols)


def solve(g: torch.Tensor):
    """The 2×2 solve of the box-summed system, +1e-3 on the determinant."""
    g11, g12, g22, h1, h2 = g.unbind(1)
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    return (g11 * h2 - g12 * h1) * idet, (g22 * h1 - g12 * h2) * idet


def tap_sum(x: torch.Tensor, k: np.ndarray, dim: int, n_out: int):
    out = float(k[0]) * x.narrow(dim, 0, n_out)
    for t in range(1, len(k)):
        out.add_(x.narrow(dim, t, n_out), alpha=float(k[t]))
    return out


def blur_valid(xp: torch.Tensor, k: np.ndarray) -> torch.Tensor:
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


def reflect_pad(x: torch.Tensor, n: int) -> torch.Tensor:
    return F.pad(x[:, None], (n, n, n, n), mode="reflect")[:, 0]


def resize(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear, half-pixel centres, no antialias."""
    if tuple(img.shape[-2:]) == (out_h, out_w):
        return img
    return F.interpolate(img[:, None], size=(out_h, out_w), mode="bilinear",
                         align_corners=False, antialias=False)[:, 0]


def hat(d: torch.Tensor, k: int) -> torch.Tensor:
    return (1.0 - (d - k).abs()).clamp(min=0.0)


# ── expansion, warp, system ───────────────────────────────────────────────


def poly_expansion_canvas(img, n, sigma, hp, wp, blur=None, margin=(0, 0)):
    """The fused route's expansion on its canvas (K2's function)."""
    g, xg, xxg, ig11, ig03, ig33, ig55 = poly_exp_coeffs(n, sigma)
    _, hk, wk = img.shape
    mr, mc = margin
    nb = 0 if blur is None else len(blur) // 2
    hh = n + nb
    ho, wo = hp + 2 * mr, wp + 2 * mc
    src = extend(img, mr + hh, hp - hk + mr + hh, mc + hh, wp - wk + mc + hh)
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
        src = hb

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
    b1, b2, b3 = horiz(s0, g, False), horiz(s1, g, False), horiz(s0, xg, True)
    b4, b5, b6 = horiz(s0, xxg, False), horiz(s2, g, False), horiz(s1, xg, True)
    return torch.stack([b2 * ig11, b3 * ig11, b1 * ig03 + b5 * ig33,
                        b1 * ig03 + b4 * ig33, b6 * ig55], dim=1)


def poly_expansion_level(img: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    """The level route's expansion on the image's own extent."""
    g, xg, xxg, ig11, ig03, ig33, ig55 = poly_exp_coeffs(n, sigma)
    h, w = img.shape[-2:]
    imgp = extend(img, n, n, 0, 0)
    s0, s1, s2 = (extend(tap_sum(imgp, k, -2, h), 0, 0, n, n) for k in (g, xg, xxg))
    b1, b2, b3 = tap_sum(s0, g, -1, w), tap_sum(s1, g, -1, w), tap_sum(s0, xg, -1, w)
    b4, b5, b6 = tap_sum(s0, xxg, -1, w), tap_sum(s2, g, -1, w), tap_sum(s1, xg, -1, w)
    return torch.stack([b2 * ig11, b3 * ig11, b1 * ig03 + b5 * ig33,
                        b1 * ig03 + b4 * ig33, b6 * ig55], dim=1)


def build_system(r0, acc, dx, dy, bsc, m_dt):
    r4 = (r0[:, 2] + acc[:, 2]) * 0.5
    r5 = (r0[:, 3] + acc[:, 3]) * 0.5
    r6 = (r0[:, 4] + acc[:, 4]) * 0.25
    b_y = (r0[:, 0] - acc[:, 0]) * 0.5
    b_x = (r0[:, 1] - acc[:, 1]) * 0.5
    r2 = b_y + r4 * dy + r6 * dx
    r3 = b_x + r6 * dy + r5 * dx
    r2, r3, r4, r5, r6 = (v * bsc for v in (r2, r3, r4, r5, r6))
    return torch.stack([r4 * r4 + r6 * r6, (r4 + r5) * r6, r5 * r5 + r6 * r6,
                        r4 * r2 + r6 * r3, r6 * r2 + r5 * r3], dim=1).to(m_dt)


def warp_build(r0, r1, dxh, dx, dy, bsc, radius, margin, m_dt):
    """Two-pass separable warp of r1 (pass 1 horizontal at each row's own
    dx, pass 2 vertical), then the system."""
    _, _, hp, wp = r0.shape
    e = radius + 1
    mr, mc = margin
    t = None
    for kx in range(-radius, radius + 2):
        tap = r1[:, :, mr - e : mr + hp + e, mc + kx : mc + kx + wp] * hat(dxh, kx)[:, None]
        t = tap if t is None else t + tap
    acc = None
    for ky in range(-radius, radius + 2):
        tap = t[:, :, e + ky : e + ky + hp] * hat(dy, ky)[:, None]
        acc = tap if acc is None else acc + tap
    return build_system(r0, acc, dx, dy, bsc, m_dt)


def update_sep(dx, dy, r0, r1, bsc, radius, margin, m_dt):
    """The first system of a level (K3's function; K5's on the level's own
    extent)."""
    _, _, hp, wp = r0.shape
    hk, wk = bsc.shape
    e = radius + 1
    dxh = extend(dx, e, hp - hk + e, 0, wp - wk).clamp(-radius, radius)
    dyc = extend(dy, 0, hp - hk, 0, wp - wk).clamp(-radius, radius)
    bscp = extend(bsc, 0, hp - hk, 0, wp - wk)
    return warp_build(r0, r1, dxh, dxh[:, e : e + hp], dyc, bscp, radius, margin, m_dt)


def win_sum_tree(a: torch.Tensor, n_out: int, win: int, dim: int = -1) -> torch.Tensor:
    """Window sums in the log-tree order of the kernels."""
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
    b, c, _, w = x.shape
    idx = (torch.arange(n_blk, device=x.device)[:, None] * CANVAS + top
           + torch.arange(rows, device=x.device)[None, :])
    out = x.index_select(2, idx.reshape(-1)).reshape(b, c, n_blk, rows, w)
    return out.transpose(1, 2).reshape(b * n_blk, c, rows, w)


def box_update(m, r0, r1, bsc, winsize, radius, emit, dt, margin=R1_MARGIN):
    """One iteration of the fused route (K4's function): the box sum as a
    running recurrence down each 32-row block, a log-tree sum across, the
    solve, then the next M (``emit='matrices'``) or the flow."""
    b, _, hp, wp = m.shape
    mm = winsize // 2
    win = 2 * mm + 1
    e = radius + 1
    ext = e if emit == "matrices" else 0
    n_blk = hp // CANVAS
    rows = CANVAS + 2 * ext
    me = extend(m.to(dt), ext + mm, ext + mm, mm, mm)
    slab = _blocks(me, rows + 2 * mm, 0, n_blk)
    s = slab[:, :, 0]
    for t in range(1, win):
        s = s + slab[:, :, t]
    vs = [s]
    for r in range(1, rows):
        s = s + slab[:, :, r + win - 1] - slab[:, :, r - 1]
        vs.append(s)
    v = torch.stack(vs, dim=2)
    g = win_sum_tree(v, wp, win) * (1.0 / (winsize * winsize))
    fdx, fdy = solve(g)
    if emit == "flow":
        fl = torch.stack([fdx, fdy], dim=1).reshape(b, n_blk, 2, CANVAS, wp)
        return fl.transpose(1, 2).reshape(b, 2, hp, wp)
    hk, wk = bsc.shape
    mr, mc = margin
    dxh = fdx.clamp(-radius, radius)
    dyc = fdy[:, e : e + CANVAS].clamp(-radius, radius)
    bscp = extend(bsc, 0, hp - hk, 0, wp - wk)[None, None]
    out = warp_build(
        _blocks(r0, CANVAS, 0, n_blk), _blocks(r1, rows, mr - e, n_blk),
        dxh, dxh[:, e : e + CANVAS], dyc,
        _blocks(bscp, CANVAS, 0, n_blk)[:, 0].repeat(b, 1, 1),
        radius, (e, mc), m.dtype,
    )
    out = out.reshape(b, n_blk, 5, CANVAS, wp).transpose(1, 2)
    return out.reshape(b, 5, hp, wp)


def box_solve(m: torch.Tensor, winsize: int):
    """The level route's box sum and solve (K6's function)."""
    _, _, h, w = m.shape
    mm = winsize // 2
    win = 2 * mm + 1
    me = extend(m, mm, mm, mm, mm)
    g = win_sum_tree(win_sum_tree(me, h, win, dim=-2), w, win)
    return solve(g * (1.0 / (winsize * winsize)))


# ── the two routes ────────────────────────────────────────────────────────


def _upscale(dx, dy, b, hk, wk, pyr_scale, dt, device):
    if dx is None:
        zero = torch.zeros((b, hk, wk), dtype=dt, device=device)
        return zero, zero
    return (resize(dx, hk, wk) * (1.0 / pyr_scale), resize(dy, hk, wk) * (1.0 / pyr_scale))


def _level_shape(h, w, pyr_scale, k):
    scale = pyr_scale**k
    sigma = (1.0 / scale - 1.0) * 0.5
    return cv_round(h * scale), cv_round(w * scale), sigma, max(cv_round(sigma * 5) | 1, 3)


def flow_fused(img0, img1, fb: dict, radius: int, dt, m_dt):
    """The fused route: a cascade pyramid, the level-0 blur inside the
    expansion, M on 32-granular canvases."""
    b, h, w = img0.shape
    ps = fb["pyr_scale"]
    levels = effective_levels(h, w, fb["levels"], ps)
    lvl = {}
    cur0, cur1 = img0, img1
    for k in range(1, levels + 1):
        scale = ps**k
        sigma_k = (1.0 / scale - 1.0) * 0.5
        hk_, wk_ = cv_round(h * scale), cv_round(w * scale)
        if k == 1:
            sz, s_blur = max(cv_round(sigma_k * 5) | 1, 3), sigma_k
        else:
            prev_scale = ps ** (k - 1)
            sigma_prev = (1.0 / prev_scale - 1.0) * 0.5
            tgt, acc = sigma_k * prev_scale, sigma_prev * prev_scale
            s_blur = float(np.sqrt(max(tgt * tgt - acc * acc, 1e-12)))
            sz = max(2 * int(np.ceil(3.0 * s_blur)) + 1, 3)
        gk = gaussian_kernel(sz, s_blur)
        nb = sz // 2
        cur0 = resize(blur_valid(reflect_pad(cur0, nb), gk), hk_, wk_)
        cur1 = resize(blur_valid(reflect_pad(cur1, nb), gk), hk_, wk_)
        lvl[k] = (cur0, cur1)
    dx = dy = None
    for k in range(levels, -1, -1):
        hk, wk, sigma, smooth_sz = _level_shape(h, w, ps, k)
        hp, wp = -(-hk // CANVAS) * CANVAS, -(-wk // CANVAS) * CANVAS
        if k == 0:
            i0, i1, blur = img0, img1, gaussian_kernel(smooth_sz, sigma)
        else:
            (i0, i1), blur = lvl[k], None
        r0 = poly_expansion_canvas(i0, fb["poly_n"], fb["poly_sigma"], hp, wp, blur)
        r1 = poly_expansion_canvas(i1, fb["poly_n"], fb["poly_sigma"], hp, wp, blur,
                                   margin=R1_MARGIN)
        dx, dy = _upscale(dx, dy, b, hk, wk, ps, dt, img0.device)
        bsc = border_scale(hk, wk, dt, img0.device)
        m = update_sep(dx, dy, r0, r1, bsc, radius, R1_MARGIN, m_dt)
        for _ in range(fb["iterations"] - 1):
            m = box_update(m, r0, r1, bsc, fb["winsize"], radius, "matrices", dt)
        fl = box_update(m, r0, r1, bsc, fb["winsize"], radius, "flow", dt)
        dx, dy = fl[:, 0, :hk, :wk], fl[:, 1, :hk, :wk]
    return dx, dy


def flow_levels(img0, img1, fb: dict, radius: int, dt):
    """The level route with the separable update: every level blurs the
    original frames, expands them on its own extent and iterates a system
    M of the compute precision."""
    b, h, w = img0.shape
    ps = fb["pyr_scale"]
    e = radius + 1
    levels = effective_levels(h, w, fb["levels"], ps)
    dx = dy = None
    for k in range(levels, -1, -1):
        hk, wk, sigma, smooth_sz = _level_shape(h, w, ps, k)
        dx, dy = _upscale(dx, dy, b, hk, wk, ps, dt, img0.device)
        n = smooth_sz // 2
        gk = gaussian_kernel(smooth_sz, sigma)
        i0 = resize(blur_valid(reflect_pad(img0, n), gk), hk, wk)
        i1 = resize(blur_valid(reflect_pad(img1, n), gk), hk, wk)
        r0 = poly_expansion_level(i0, fb["poly_n"], fb["poly_sigma"])
        r1p = extend(poly_expansion_level(i1, fb["poly_n"], fb["poly_sigma"]), e, e, e, e)
        bsc = border_scale(hk, wk, dt, img0.device)
        m = update_sep(dx, dy, r0, r1p, bsc, radius, (e, e), dt)
        for i in range(fb["iterations"]):
            dx, dy = box_solve(m, fb["winsize"])
            if i < fb["iterations"] - 1:
                m = update_sep(dx, dy, r0, r1p, bsc, radius, (e, e), dt)
    return dx, dy


def fused_route(fb: dict) -> bool:
    """Whether ``'auto'`` takes the fused route for these parameters (the
    fused route's halos end at winsize//2 = 8 and poly_n = 7)."""
    return not (fb["winsize"] // 2 > 8 or fb["poly_n"] > 7)


def flow(prev, nxt, fb: dict, radius: int, dt=torch.float32):
    """``[B, H, W]`` frames → (dx, dy) ``[B, H, W]`` by the route that
    ``'auto'`` takes: the fused one (M in bfloat16) or the level one."""
    img0 = prev.to(dt).contiguous()
    img1 = nxt.to(dt).contiguous()
    if fused_route(fb):
        return flow_fused(img0, img1, fb, radius, dt, torch.bfloat16)
    return flow_levels(img0, img1, fb, radius, dt)
