"""Deterministic synthetic event fixture: a box moving left→right.

The port's copy of :mod:`nsof_tpu.device.synthetic` (numpy only): a
vectorised re-design of the reference's ``generate_synthetic_events``
(eventsim/event_mem_sim.py:109-158), which loops over frames and pixels in
Python.  Semantics are identical: a white box on black background translates
at ``speed_pps`` px/s; per timestep ON events (+1) fire where the frame turns
on (leading edge) and OFF events (-1) where it turns off (trailing edge);
events are sorted by timestamp (stable, ON before OFF within a timestep,
matching the reference's append order).

Note the polarity quirk faithfully carried over: the generator emits OFF
events with p = -1, while the simulator's 'split' mode matches OFF events
with p == 0 (event_mem_sim.py:250) — so on synthetic data only the ON array
is driven, exactly as in the reference.
"""

from __future__ import annotations

import numpy as np

from nsof_tpu_torch.device.model import DT


def generate_synthetic_events(
    height: int = 240,
    width: int = 320,
    box_h: int = 50,
    box_w: int = 50,
    speed_pps: int = 300,
    duration_s: float = 1.5,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (x, y, p, t_us) arrays for the moving-box event stream."""
    t_step_us = int(DT * 1_000_000)
    duration_us = int(duration_s * 1_000_000)
    box_y0 = (height - box_h) // 2
    ys = np.arange(box_y0, box_y0 + box_h)

    xs_out, ys_out, ps_out, ts_out = [], [], [], []
    prev_cols = np.zeros(width, dtype=bool)
    for t_us in range(0, duration_us, t_step_us):
        t_s = t_us / 1_000_000
        x0 = int(t_s * speed_pps)
        x1 = x0 + box_w
        cols = np.zeros(width, dtype=bool)
        if x0 < width and x1 > 0:
            cols[max(0, x0) : min(width, x1)] = True
        on_cols = np.where(cols & ~prev_cols)[0]
        off_cols = np.where(~cols & prev_cols)[0]
        # np.where on a 2-D diff image yields row-major (y, x) order; the box
        # occupies full column strips so iterate rows outer, cols inner.
        for pol, cc in ((1, on_cols), (-1, off_cols)):
            if cc.size == 0:
                continue
            yy = np.repeat(ys, cc.size)
            xx = np.tile(cc, ys.size)
            xs_out.append(xx)
            ys_out.append(yy)
            ps_out.append(np.full(xx.size, pol, np.int64))
            ts_out.append(np.full(xx.size, t_us, np.int64))
        prev_cols = cols

    if not xs_out:
        e = np.array([], dtype=int)
        return e, e, e, e
    x = np.concatenate(xs_out)
    y = np.concatenate(ys_out)
    p = np.concatenate(ps_out)
    t = np.concatenate(ts_out)
    order = np.argsort(t, kind="stable")
    return x[order], y[order], p[order], t[order]
