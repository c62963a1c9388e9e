"""``kernel_mode='fused_f32'``: the float32 forms of K3 and K4, and the route
end to end, against the JAX package with its Pallas kernels in TPU
interpret mode.

K3 and K4 plain versions with float32 M against ``_update_matrices_sep_cm(
out_dtype=float32)`` and ``_fused_box_update_cm`` on a 40×50 level (canvas
64×64), B = 128; the route, ``farneback_fast(kernel_mode='fused_f32')``, on
64×96 frames of a texture moved by (2, −1) px, grasp preset, warp radius 3,
B = 128.  Inputs made with numpy from a seed.

Measured here: K3 and K4 M′ within 2.4e-7 of their channel's largest
magnitude; K4's flow within 1e-6 px; the route's flow max 5.5e-6 px, mean
2.1e-7 px.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nsof_tpu.ops import farneback_fast as jff
from nsof_tpu.ops.farneback import PRESETS as JAX_PRESETS
from nsof_tpu_torch.ops import farneback_fast as tff
from nsof_tpu_torch.ops.farneback import PRESETS, _gaussian_blur_kernel

B, HK, WK = 128, 40, 50
HP, WP = 64, 64
RADIUS = 3
E = RADIUS + 1
WINSIZE = 15
BLUR = _gaussian_blur_kernel(3, 0.0)


def _cm(x):
    """[B, C, H, W] → the JAX kernels' channel-major [C, H, W, B]."""
    return jnp.asarray(np.ascontiguousarray(np.moveaxis(x, 0, -1)))


def _bm(x):
    """[C, H, W, B] JAX array → [B, C, H, W] float32 numpy."""
    return np.moveaxis(np.asarray(x), -1, 0)


def _pad_hw(x, top=0, bottom=0):
    """edge-pad [H, W, B] to the canvas, with extra rows (the JAX padc)."""
    return np.pad(x, [(top, HP - HK + bottom), (0, WP - WK), (0, 0)], mode="edge")


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    img0 = (rng.random((B, HK, WK)) * 255).astype(np.float32)
    img1 = (rng.random((B, HK, WK)) * 255).astype(np.float32)
    coarse = rng.normal(size=(B, 2, HK // 8 + 2, WK // 8 + 2)).astype(np.float32) * 2.5
    flow = torch.nn.functional.interpolate(
        torch.from_numpy(coarse), size=(HK, WK), mode="bilinear").numpy()
    dx, dy = np.ascontiguousarray(flow[:, 0]), np.ascontiguousarray(flow[:, 1])
    t = torch.from_numpy
    r0 = tff.poly_expansion(t(img0), 5, 1.2, HP, WP, BLUR)
    r1 = tff.poly_expansion(t(img1), 5, 1.2, HP, WP, BLUR, margin=(8, 16))
    bsc = tff.border_scale(HK, WK, "cpu")
    m = tff.update_matrices_sep(t(dx), t(dy), r0, r1, bsc, RADIUS,
                                out_dtype=torch.float32)
    got = {
        "k3": m.numpy(),
        "matrices": tff.fused_box_update(m, r0, r1, bsc, WINSIZE, RADIUS,
                                         "matrices").numpy(),
        "flow": tff.fused_box_update(m, r0, r1, bsc, WINSIZE, RADIUS,
                                     "flow").numpy(),
    }
    bscp = np.pad(jff._border_scale_hw(HK, WK)[..., None],
                  [(0, HP - HK), (0, WP - WK), (0, 0)], mode="edge")
    dxj, dyj = np.moveaxis(dx, 0, -1), np.moveaxis(dy, 0, -1)
    r0j, r1j = _cm(r0.numpy()), _cm(r1.numpy())
    ref = {}
    with pltpu.force_tpu_interpret_mode():
        ref["k3"] = _bm(jff._update_matrices_sep_cm(
            jnp.asarray(_pad_hw(dxj)), jnp.asarray(_pad_hw(dyj)), r0j,
            jnp.asarray(bscp), r1j, jnp.asarray(_pad_hw(dxj, E, E)), RADIUS,
            32, 32, out_dtype=jnp.float32, r1_off=(8 - E, 8)))
        for emit in ("matrices", "flow"):
            ref[emit] = _bm(jff._fused_box_update_cm(
                _cm(got["k3"]), r0j, jnp.asarray(bscp), r1j, WINSIZE, RADIUS,
                emit, 32, 32, r1_off=(8 - E, 8)))
    return got, ref


@pytest.mark.parametrize("name", ["k3", "matrices"])
def test_f32_system_matches_pallas(case, name):
    """K3 and K4 with float32 M: every element within 1e-6 of its
    channel's largest magnitude."""
    got, ref = case
    assert got[name].dtype == ref[name].dtype == np.float32
    assert got[name].shape == ref[name].shape == (B, 5, HP, WP)
    chmax = np.abs(ref[name]).max(axis=(0, 2, 3), keepdims=True)
    assert (np.abs(got[name] - ref[name]) <= 1e-6 * chmax).all()


def test_f32_flow_matches_pallas(case):
    got, ref = case
    assert got["flow"].shape == ref["flow"].shape == (B, 2, HP, WP)
    assert np.abs(got["flow"] - ref["flow"]).max() <= 1e-5


def test_fused_f32_route_matches_jax():
    """The route end to end: flow ≤ 1e-4 px max, ≤ 1e-6 px mean."""
    h, w = 64, 96
    rng = np.random.default_rng(1)
    base = rng.random((h + 64, w + 64)).astype(np.float32) * 255
    prev = np.stack([base[16 + v % 5 : 16 + v % 5 + h, 16 : 16 + w]
                     for v in range(B)]).astype(np.uint8)
    nxt = np.stack([base[18 + v % 5 : 18 + v % 5 + h, 15 : 15 + w]
                    for v in range(B)]).astype(np.uint8)
    got = tff.farneback_fast(prev, nxt, PRESETS["grasp"], RADIUS, "fused_f32",
                             device="cpu").numpy()
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jff.farneback_fast(jnp.asarray(prev), jnp.asarray(nxt),
                                            JAX_PRESETS["grasp"], RADIUS, "fused_f32"))
    assert got.shape == ref.shape == (B, h, w, 2)
    err = np.abs(got - ref)
    assert err.max() <= 1e-4
    assert err.mean() <= 1e-6
