"""Where the exact Farnebäck of the port and the JAX package's part on an
ill-conditioned window: ``tests/torch_runner_scene.py``'s 64×96 ROI window
of pair 0 (tabletennis preset: poly_n 1, winsize 4, 2 levels run), a flat
24×24 box moving (2, 3) px over an unblurred random texture.  The two
flows are 0.155 px apart at pixel (35, 37), inside the flat box near its
top-left corner; the 72 pixels more than 1e-3 px apart all lie in rows
26–37, columns 30–38 (flows of 4–13 px there), the mean difference is
4.4e-4 px.

- Stage by stage, each fed the JAX stage's own inputs, the port agrees with
  the un-jitted JAX function to float32 rounding: the Gaussian blur equal,
  the bilinear resizes within 4 ulp, the polynomial expansion within 2e-6
  of its range (XLA's convolution sums its taps in another order), the box
  sums within 3 ulp, ``update_matrices`` and the 2×2 solve bit for bit.
- With JAX's resizes, expansions and box sums substituted into the port's
  chain, the port's flow equals JAX's bit for bit: no other op differs.
- The 0.155 px is those few ulps amplified by the systems around the flat
  box: in the first level-0 solve its neighbour (34, 36) has det 0.487
  with g22 0.078 (flow −5.75 px), so its flow moves by 8.7e-3 px, and 17 of
  the 25 pixels of (35, 37)'s 5×5 box have det 0 and one 2.5e-3 (the +1e-3
  regulariser all but alone).  The JAX function itself moves by 2.5e-3 px there
  between eager and jitted runs.  Not a fault of the port (ROADMAP queue 3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsof_tpu.ops import farneback as jfb
from nsof_tpu.ops import roi as jroi
from nsof_tpu_torch.ops import farneback as tfb
from torch_runner_scene import H, W, scenes
from torch_single_thread import one_torch_thread  # noqa: F401  (autouse)

PIXEL = (35, 37)
ULP = np.finfo(np.float32).eps


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.fixture(scope="module")
def window():
    jscene, _ = scenes()
    cfg = jscene.cfg
    mem, prev, nxt = jscene.pair_inputs(0)
    box = jroi.roi_boxes(jnp.asarray(mem), H, W, cfg.roi)["merged"]
    oy, ox = (int(v) for v in jroi.window_origin(box, 64, 96, H, W))
    crop = (slice(oy, oy + 64), slice(ox, ox + 96))
    return prev[crop].astype(np.float32), nxt[crop].astype(np.float32), cfg.fb


def _levels(p, params):
    h, w = p.shape
    for k in range(jfb._effective_levels(h, w, params.levels, params.pyr_scale), -1, -1):
        scale = params.pyr_scale ** k
        sigma = (1.0 / scale - 1.0) * 0.5
        yield (k, max(jfb._cv_round(sigma * 5) | 1, 3), sigma, jfb._cv_round(h * scale),
               jfb._cv_round(w * scale))


def _port_chain(p, n, params, jax_stages=()):
    """The port's exact Farnebäck on one pair, with the stages named in
    ``jax_stages`` ('resize', 'poly', 'box') computed by the JAX package."""
    dx = dy = None
    for _, sz, sigma, hk, wk in _levels(p, params):
        if dx is None:
            dx = dy = torch.zeros((1, hk, wk))
        elif "resize" in jax_stages:
            f = jfb._resize_linear(jnp.stack([jnp.asarray(dx[0]), jnp.asarray(dy[0])], -1),
                                   hk, wk) * (1.0 / params.pyr_scale)
            dx, dy = _t(f[..., 0])[None], _t(f[..., 1])[None]
        else:
            dx, dy = (tfb._resize_hwb(v, hk, wk) * (1.0 / params.pyr_scale) for v in (dx, dy))
        if "resize" in jax_stages:
            imgs = [_t(jfb._resize_linear(jfb._gaussian_blur(jnp.asarray(x), sz, sigma), hk,
                                          wk))[None] for x in (p, n)]
        else:
            imgs = [tfb._resize_hwb(tfb._gaussian_blur(_t(x)[None], sz, sigma), hk, wk)
                    for x in (p, n)]
        if "poly" in jax_stages:
            r0, r1 = (_t(jfb.poly_expansion(jnp.asarray(i[0]), params.poly_n,
                                            params.poly_sigma)).permute(2, 0, 1)[None]
                      for i in imgs)
        else:
            r0, r1 = (tfb.poly_expansion(i, params.poly_n, params.poly_sigma) for i in imgs)
        m = tfb.update_matrices(r0, r1, dx, dy)
        for it in range(params.iterations):
            if "box" in jax_stages:
                g = torch.stack([_t(jfb._box_sum(jnp.asarray(m[0, c]), params.winsize // 2))
                                 for c in range(5)])[None]
            else:
                g = tfb._box_sum(m, params.winsize // 2)
            dx, dy = tfb._solve(g * (1.0 / (params.winsize * params.winsize)))
            if it < params.iterations - 1:
                m = tfb.update_matrices(r0, r1, dx, dy)
    return torch.stack([dx[0], dy[0]], -1).numpy()


def test_the_flows_part_inside_the_flat_box(window):
    """The flows part at a few pixels (by the flat box, per the module's
    docstring).  Bounds only: those numbers are a record of rounding, not a
    property to keep."""
    p, n, params = window
    want = np.asarray(jfb._farneback_f32(p, n, params))
    got = tfb.farneback(p, n, params, device="cpu").numpy()
    diff = np.abs(got - want).max(-1)
    assert diff.max() < 0.2
    assert diff.mean() < 1e-3
    assert (diff > 1e-3).mean() < 0.02
    np.testing.assert_array_equal(_port_chain(p, n, params), got)


def test_each_stage_agrees_to_rounding(window):
    """Every stage, fed the JAX stage's inputs, within a few ulps."""
    p, n, params = window
    jf = None
    for k, sz, sigma, hk, wk in _levels(p, params):
        jblur = jfb._gaussian_blur(jnp.asarray(p), sz, sigma)
        np.testing.assert_array_equal(tfb._gaussian_blur(_t(p)[None], sz, sigma)[0].numpy(),
                                      np.asarray(jblur))
        ji0 = jfb._resize_linear(jblur, hk, wk)
        ti0 = tfb._resize_hwb(_t(jblur)[None], hk, wk)[0].numpy()
        np.testing.assert_allclose(ti0, np.asarray(ji0), rtol=4 * ULP, atol=0)
        ji1 = jfb._resize_linear(jfb._gaussian_blur(jnp.asarray(n), sz, sigma), hk, wk)
        jr0 = jfb.poly_expansion(ji0, params.poly_n, params.poly_sigma)
        jr1 = jfb.poly_expansion(ji1, params.poly_n, params.poly_sigma)
        tr0 = tfb.poly_expansion(_t(ji0)[None], params.poly_n, params.poly_sigma)[0]
        span = np.abs(np.asarray(jr0)).max()
        np.testing.assert_allclose(tr0.permute(1, 2, 0).numpy(), np.asarray(jr0), rtol=0,
                                   atol=2e-6 * span)
        jf = jnp.zeros((hk, wk, 2)) if jf is None else jfb._resize_linear(
            jf, hk, wk) * (1.0 / params.pyr_scale)
        r0, r1 = (_t(r).permute(2, 0, 1)[None] for r in (jr0, jr1))
        jm = jfb.update_matrices(jr0, jr1, jf)
        tm = tfb.update_matrices(r0, r1, _t(jf[..., 0])[None], _t(jf[..., 1])[None])
        np.testing.assert_array_equal(tm[0].permute(1, 2, 0).numpy(), np.asarray(jm))
        for it in range(params.iterations):
            half = params.winsize // 2
            m = _t(jm).permute(2, 0, 1)[None]
            for c in range(5):
                jg = np.asarray(jfb._box_sum(jm[..., c], half))
                np.testing.assert_allclose(tfb._box_sum(m[:, c], half)[0].numpy(), jg,
                                           rtol=3 * ULP, atol=3 * ULP * np.abs(jg).max())
            jf, jm = jfb.update_flow_blur(jr0, jr1, jf, jm, params.winsize,
                                          update_mats=it < params.iterations - 1)


def test_jax_resizes_expansions_and_box_sums_make_the_chains_equal(window):
    p, n, params = window
    want = np.asarray(jfb._farneback_f32(p, n, params))
    np.testing.assert_array_equal(_port_chain(p, n, params, ("resize", "poly", "box")), want)
    # without JAX's box sums the flows part again, by rounding amplified
    assert np.abs(_port_chain(p, n, params, ("resize", "poly")) - want).max() > 0


def test_the_pixel_sits_by_singular_systems(window):
    """The first level-0 solve's systems around the pixel: its neighbour
    (34, 36) ill-conditioned, most of the pixels of its box singular (the
    flat box's systems are exactly zero whatever the order of the sums)."""
    p, n, params = window
    jf = None
    for k, sz, sigma, hk, wk in _levels(p, params):
        jf = jnp.zeros((hk, wk, 2)) if jf is None else jfb._resize_linear(
            jf, hk, wk) * (1.0 / params.pyr_scale)
        i0, i1 = (jfb._resize_linear(jfb._gaussian_blur(jnp.asarray(x), sz, sigma), hk, wk)
                  for x in (p, n))
        r0, r1 = (jfb.poly_expansion(i, params.poly_n, params.poly_sigma) for i in (i0, i1))
        m = jfb.update_matrices(r0, r1, jf)
        if k == 0:
            g = np.stack([np.asarray(jfb._box_sum(m[..., c], params.winsize // 2))
                          for c in range(5)], -1) / params.winsize ** 2
            det = g[..., 0] * g[..., 2] - g[..., 1] ** 2
            assert det[34, 36] < 1 and g[34, 36, 2] < 0.1
            y, x = PIXEL
            assert (det[y - 2: y + 3, x - 2: x + 3] == 0).sum() > 12
            return
        for it in range(params.iterations):
            jf, m = jfb.update_flow_blur(r0, r1, jf, m, params.winsize,
                                         update_mats=it < params.iterations - 1)
