"""The benchmark's one input generator: frames and state maps from a seed.

Every traffic mix is a data file of parameters (``benchmark/workloads/
<cell>.json``, key ``params``) that this module reads; nothing here knows a
cell by name.  Images are textures made of a few random plane waves, so
they can be evaluated at any sub-pixel offset: a moving object is the same
texture sampled at shifted coordinates, with no resampling filter between
the two frames.  The per-sample draws come from numpy's generator seeded
with ``--seed``; the pixels are rendered on the device from them.

- :func:`pairs`: ``n`` independent frame pairs with their state maps.  Each
  sample's state map is active on one block of cells; a textured object
  inside that block moves by a shift within ±``shift_px`` per axis, whole
  and fractional.  The block sizes, and which samples have no active cell
  (one in ``inactive_every``), are one fixed multiset in a seeded order, so
  every seed gives the same work.
- :func:`sequence`: a periodic stream of frames, a static background and
  objects moving along triangle-wave paths that close after ``period``
  frames.  The paths are the parameters' (``cycles`` and ``path_phase``):
  how long the device's cells keep changing, and so the device scan's
  work, follows the paths, so only the textures come from the seed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

RENDER_PX = 1 << 26  # sample-pixels rendered at once


def _chunk(h: int, w: int) -> int:
    return max(1, RENDER_PX // (h * w))


def _rng(seed: int, salt: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, salt])


def _waves(rng, n: int, p: dict) -> np.ndarray:
    """``[n, waves, 4]`` plane waves (fy, fx, phase, amplitude) a texture."""
    k = p["texture_waves"]
    lo, hi = p["wavelength_px"]
    wl = np.exp(rng.uniform(np.log(lo), np.log(hi), (n, k)))
    th = rng.uniform(0, 2 * np.pi, (n, k))
    amp = rng.uniform(0.5, 1.0, (n, k)) * p["contrast"] / np.sqrt(k)
    return np.stack([np.sin(th) / wl, np.cos(th) / wl,
                     rng.uniform(0, 2 * np.pi, (n, k)), amp], axis=-1)


def _render(waves: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
            mean: float = 128.0) -> torch.Tensor:
    """Textures ``[c, H, W]`` float64: mean + Σ amp·sin(2π(fy·y + fx·x) + φ)
    for ``waves`` ``[c, k, 4]`` float64 at row coordinates ``ys`` ``[c, H]``
    and column coordinates ``xs`` ``[c, W]``.  Each wave is separable,
    sin(a + b) = sin a·cos b + cos a·sin b, so a texture is one batched
    product of ``[c, H, 2k]`` by ``[c, 2k, W]``."""
    fy, fx, ph, amp = (waves[:, None, :, i] for i in range(4))
    a = (2 * math.pi) * fy * ys[:, :, None] + ph  # [c, H, k]
    b = (2 * math.pi) * fx * xs[:, :, None]  # [c, W, k]
    rows = torch.cat([amp * torch.sin(a), amp * torch.cos(a)], dim=2)
    cols = torch.cat([torch.cos(b), torch.sin(b)], dim=2).transpose(1, 2)
    return torch.baddbmm(torch.full((1, 1, 1), mean, dtype=torch.float64, device=ys.device),
                         rows, cols)


def _u8(x: torch.Tensor) -> torch.Tensor:
    return x.round().clamp(0, 255).to(torch.uint8)


def pairs(seed: int, cfg: dict, p: dict, n: int, device, salt: int = 0):
    """``n`` frame pairs from ``seed``: ``mem`` ``[n, gh, gw]``, ``prev``
    and ``nxt`` ``[n, H, W]``, all uint8 on ``device``.  ``salt`` tells
    apart the batches a cell keeps."""
    rng = _rng(seed, 1 + salt)
    h, w = cfg["image_h"], cfg["image_w"]
    ms, thres = cfg["roi"]["memsize"], cfg["roi"]["thres"]
    gh, gw = h // ms, w // ms
    shapes = [(bh, bw) for bh in range(p["block_rows"][0], p["block_rows"][1] + 1)
              for bw in range(p["block_cols"][0], p["block_cols"][1] + 1)]
    order = rng.permutation(n)
    bh = np.array([shapes[i % len(shapes)][0] for i in order])
    bw = np.array([shapes[i % len(shapes)][1] for i in order])
    active = np.array([i % p["inactive_every"] != 0 for i in order])
    r0 = rng.integers(0, gh - bh + 1)
    c0 = rng.integers(0, gw - bw + 1)
    shift = rng.uniform(-p["shift_px"], p["shift_px"], (n, 2))
    mem = rng.integers(0, thres, (n, gh, gw))
    hot = rng.integers(thres, 256, (n, gh, gw))
    cells_y, cells_x = np.indices((gh, gw))
    block = ((cells_y >= r0[:, None, None]) & (cells_y < (r0 + bh)[:, None, None])
             & (cells_x >= c0[:, None, None]) & (cells_x < (c0 + bw)[:, None, None]))
    mem = np.where(block & active[:, None, None], hot, mem).astype(np.uint8)
    m = p["object_margin_px"]
    rect = np.stack([r0 * ms + m, (r0 + bh) * ms - m, c0 * ms + m, (c0 + bw) * ms - m], 1)
    bg, ob = _waves(rng, n, p), _waves(rng, n, p)

    prev = torch.empty((n, h, w), dtype=torch.uint8, device=device)
    nxt = torch.empty_like(prev)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)  # noqa: E731
    y = torch.arange(h, dtype=torch.float64, device=device)[None, :]
    x = torch.arange(w, dtype=torch.float64, device=device)[None, :]
    step = _chunk(h, w)
    for s in range(0, n, step):
        e = min(s + step, n)
        rc = t(rect[s:e])[:, :, None]
        sy, sx = (t(shift[s:e, i])[:, None] for i in (0, 1))
        back = _render(t(bg[s:e]), y.expand(e - s, h), x.expand(e - s, w))
        for out, dy, dx in ((prev, 0.0, 0.0), (nxt, sy, sx)):
            yy, xx = (y - dy).expand(e - s, h), (x - dx).expand(e - s, w)
            inside = (((yy >= rc[:, 0]) & (yy < rc[:, 1]))[:, :, None]
                      & ((xx >= rc[:, 2]) & (xx < rc[:, 3]))[:, None, :])
            out[s:e] = _u8(torch.where(inside, _render(t(ob[s:e]), yy, xx), back))
    return torch.as_tensor(mem, device=device), prev, nxt


def sequence(seed: int, cfg: dict, p: dict, device) -> torch.Tensor:
    """``[period + 1, H, W]`` uint8 frames on ``device``; frame ``period``
    is frame 0, so chunk ``c`` of ``chunk`` pairs is frames
    ``[c·chunk, (c+1)·chunk]`` and the stream runs on without a seam."""
    rng = _rng(seed, 0)
    h, w = cfg["image_h"], cfg["image_w"]
    period = p["period"]
    objs, cycles, phase = p["objects_hw"], p["cycles"], p["path_phase"]
    waves = _waves(rng, 1 + len(objs), p)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)  # noqa: E731
    y = torch.arange(h, dtype=torch.float64, device=device)[None, :]
    x = torch.arange(w, dtype=torch.float64, device=device)[None, :]
    # the objects are brighter than the background on average, as a cell's
    # mean is what the device grid sees
    off = p["object_offset"] / 2
    back = _render(t(waves[:1]), y, x, 128.0 - off)
    frames = torch.empty((period + 1, h, w), dtype=torch.uint8, device=device)
    step = _chunk(h, w)
    for s in range(0, period, step):
        ts = np.arange(s, min(s + step, period))
        img = back.expand(len(ts), h, w)
        for j, (oh, ow) in enumerate(objs):
            # a triangle wave over the free range, cycles[j] times a period
            u = (np.asarray(cycles[j])[None, :] * ts[:, None] / period + phase[j]) % 1.0
            tri = 1.0 - np.abs(2.0 * u - 1.0)
            yy = y - t(tri[:, 0] * (h - oh))[:, None]
            xx = x - t(tri[:, 1] * (w - ow))[:, None]
            inside = ((yy >= 0) & (yy < oh))[:, :, None] & ((xx >= 0) & (xx < ow))[:, None, :]
            tex = _render(t(waves[1 + j : 2 + j]).expand(len(ts), -1, -1), yy, xx,
                          128.0 + off)
            img = torch.where(inside, tex, img)
        frames[ts[0] : ts[-1] + 1] = _u8(img)
    frames[period] = frames[0]
    return frames
