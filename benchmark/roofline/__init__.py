"""Operations and bytes from shapes alone, and the chip's peaks.

The least time of a piece of work is the larger of its float32 operations
over the chip's float32 rate and its bytes over the memory's rate; a
roofline share is that least time over the measured time.  The counts here
depend only on a configuration's shapes and its Farnebäck preset (and the
traffic's sizes), never on a kernel, so they stay valid when a kernel is
fused, split or removed:

- :func:`k4_counts` and :func:`k5_counts`: one pair's work of the kernels
  K4 (the fused route's box sum, solve and next system) and K5 (the level
  route's separable update), summed over the launches of one call, by the
  reckoning the port's smoke test used for their bounds;
- :func:`step_counts`: one pair's work of the whole step, every input read
  once and every output written once, and the float operations of the
  flow, the head's threshold and, on the stream, the compression and the
  device scan.  The morphology's boolean operations are not float work and
  are not counted.
"""

from __future__ import annotations

from benchmark.reference.farneback import (CANVAS, cv_round, effective_levels,
                                           fused_route)

# NVIDIA H100 SXM, published dense peaks at 700 W
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def least_seconds(ops: float, nbytes: float) -> float:
    return max(ops / F32_FLOPS, nbytes / HBM_BYTES_PER_S)


def tree_adds(win: int) -> int:
    """Additions of a log-tree window sum of width ``win``, every partial
    sum computed once."""
    return (win.bit_length() - 1) + (bin(win).count("1") - 1)


def levels(cfg: dict) -> list[tuple[int, int]]:
    """(hk, wk) of each pyramid level of the flow's window, finest first."""
    h, w = cfg["window_h"] or cfg["image_h"], cfg["window_w"] or cfg["image_w"]
    fb = cfg["fb"]
    n = effective_levels(h, w, fb["levels"], fb["pyr_scale"])
    return [(cv_round(h * fb["pyr_scale"] ** k), cv_round(w * fb["pyr_scale"] ** k))
            for k in range(n + 1)]


def _warp_ops(radius: int, rows: int) -> float:
    """A pixel's separable warp (pass 1 over ``rows`` + 2(r+1) rows) and
    system build."""
    taps = 2 * radius + 2
    return taps * 14 * (1 + 2 * (radius + 1) / rows) + taps * 14 + 34


def _box_ops(winsize: int) -> float:
    """A pixel's box sum of the five channels (a running sum down, a
    log tree across, a scale) and the 2×2 solve."""
    win = 2 * (winsize // 2) + 1
    return 5 * (2 + tree_adds(win) + 1) + 11


def k4_counts(cfg: dict) -> tuple[float, float]:
    """(operations, bytes) of one pair's K4 launches: per level,
    ``iterations`` − 1 with the next system (M in bfloat16) and one with
    the flow.  A launch of the next system reads M, r0, r1 around its warp
    reach and the border scale and writes M, and recomputes the flow of
    each 32-row tile's ±(radius + 1) halo rows; one of the flow reads M and
    writes the flow."""
    fb, r = cfg["fb"], cfg["warp_radius"]
    e = r + 1
    box = _box_ops(fb["winsize"])
    ops = nbytes = 0.0
    for hk, wk in levels(cfg):
        hp, wp = -(-hk // CANVAS) * CANVAS, -(-wk // CANVAS) * CANVAS
        px = hp * wp
        r1_read = 5 * (hp + 2 * r + 1) * (wp + 2 * r + 1) * 4
        mats = fb["iterations"] - 1
        ops += mats * px * (box * (1 + 2 * e / CANVAS) + _warp_ops(r, hp)) + px * box
        nbytes += mats * (px * 10 + px * 20 + r1_read + hk * wk * 4 + px * 10)
        nbytes += px * 10 + px * 8
    return ops, nbytes


def k5_counts(cfg: dict) -> tuple[float, float]:
    """(operations, bytes) of one pair's K5 launches, ``iterations`` a
    level: each reads the flow, r0, r1 around its warp reach and the border
    scale, and writes M in float32."""
    fb, r = cfg["fb"], cfg["warp_radius"]
    ops = nbytes = 0.0
    for h, w in levels(cfg):
        px = h * w
        ops += fb["iterations"] * px * _warp_ops(r, h)
        nbytes += fb["iterations"] * (px * 8 + h * w * 4 + px * 20
                                      + 5 * (h + 2 * r + 1) * (w + 2 * r + 1) * 4 + px * 20)
    return ops, nbytes


def flow_ops(cfg: dict) -> float:
    """Float operations of one pair's flow on its window: the pyramid's
    blurs and resizes, both frames' expansions, then per level the first
    system and ``iterations`` box sums and solves, each but the last
    followed by the next system."""
    fb, r = cfg["fb"], cfg["warp_radius"]
    n = fb["poly_n"]
    lv = levels(cfg)
    expand = 27 * n + 12
    update = _warp_ops(r, lv[0][0])
    box = _box_ops(fb["winsize"])
    ops = 0.0
    for k, (hk, wk) in enumerate(lv):
        px = hk * wk
        sigma = (1.0 / fb["pyr_scale"] ** k - 1.0) * 0.5
        taps = max(cv_round(sigma * 5) | 1, 3)
        if fused_route(fb) and k > 0:
            # the cascade: the previous level blurred, then resized
            src = lv[k - 1][0] * lv[k - 1][1]
        else:
            # level 0's blur (fused into the expansion), the level route's
            # blur of the full frame at every level
            src = lv[0][0] * lv[0][1]
        ops += 2 * (src * 2 * 2 * taps + (8 * px if k > 0 else 0))
        ops += 2 * px * expand
        ops += px * (fb["iterations"] * (update + box))
    return ops


def step_counts(cfg: dict, traffic: str, params: dict) -> tuple[float, float]:
    """(operations, bytes) of one pair of a cell's step: ``seg_batch_fast``
    with the flow returned (batch traffic), or ``stream_masks``
    (stream traffic: a chunk of k + 1 frames for k pairs, the compression,
    the device scan of every cell for every substep, its gating maps)."""
    h, w = cfg["image_h"], cfg["image_w"]
    wh, ww = cfg["window_h"] or h, cfg["window_w"] or w
    gh, gw = h // cfg["roi"]["memsize"], w // cfg["roi"]["memsize"]
    ops = flow_ops(cfg) + 4 * wh * ww  # + the head's |flow|² > SEG_TH²
    out_bytes = h * w + h * w * 8 + 16 + 1 + 4  # mask, flow, box, any_active, region %
    if traffic != "stream":
        return ops, 2 * h * w + gh * gw + out_bytes
    k = params["chunk_pairs"]
    sim = params["sim"]
    sh, sw = h // sim["n"], w // sim["m"]
    frame_ops = 2 * sh * h * w + 2 * sh * w * sw  # the two products a frame
    scan_ops = 40 * sim["n_substeps"] * sh * sw  # ≈ 40 operations a substep
    ops += frame_ops * (k + 1) / k + scan_ops
    nbytes = h * w * (k + 1) / k + out_bytes + sh * sw * (1 + 8 / k)
    return ops, nbytes
