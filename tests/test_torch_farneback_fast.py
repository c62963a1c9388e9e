"""The plain versions of kernels K2–K4 and the pyramid glue against the JAX
package's fused route, its Pallas kernels run in TPU interpret mode.

Inputs: a 40×50 level (canvas 64×64, so the canvas's slack rows and columns
are exercised), B = 128 (the JAX grids' lane width), made with numpy from a
seed.  Measured here: K2 within 3.3e-5 of the Pallas kernel on 0–255
images; K3 and K4 M′ ≥ 99.5 % bit-equal, the elements more than one bf16
ulp apart all below 2e-5 of their channel's largest magnitude; K4's flow
within 1e-6 px.  K4 is held at the grasp pair (winsize 15, radius 3) and at
tabletennis's (4, 5) by the same tolerances; K2 also at tabletennis's poly_n
1 (sigma 1.05) and K3 at its warp radius 5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nsof_tpu.ops import farneback_fast as jff
from nsof_tpu.ops.farneback import FarnebackParams
from nsof_tpu_torch.ops import farneback_fast as tff
from nsof_tpu_torch.ops.farneback import _gaussian_blur_kernel

B, HK, WK = 128, 40, 50
HP, WP = 64, 64
RADIUS = 3
E = RADIUS + 1
WINSIZE = 15
BLUR = _gaussian_blur_kernel(3, 0.0)
K2_CASES = {
    "plain": dict(n=5, sigma=1.2, blur=None, th=16, tw=32, margin=(0, 0)),
    "blur": dict(n=5, sigma=1.2, blur=BLUR, th=16, tw=32, margin=(0, 0)),
    "blur_margin": dict(n=5, sigma=1.2, blur=BLUR, th=8, tw=16, margin=(8, 16)),
    "tabletennis_blur_margin": dict(n=1, sigma=1.05, blur=BLUR, th=8, tw=16,
                                    margin=(8, 16), atol=3e-4),
}


def _cm(x):
    """[B, C, H, W] → the JAX kernels' channel-major [C, H, W, B]."""
    return jnp.asarray(np.ascontiguousarray(np.moveaxis(x, 0, -1)))


def _bm(x):
    """[C, H, W, B] JAX array → [B, C, H, W] float32 numpy."""
    return np.moveaxis(np.asarray(jnp.asarray(x, jnp.float32)), -1, 0)


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
    m = tff.update_matrices_sep(t(dx), t(dy), r0, r1, bsc, RADIUS)
    got = {
        "k3": m.float().numpy(),
        "matrices": tff.fused_box_update(m, r0, r1, bsc, WINSIZE, RADIUS,
                                         "matrices").float().numpy(),
        "flow": tff.fused_box_update(m, r0, r1, bsc, WINSIZE, RADIUS,
                                     "flow").numpy(),
    }
    for name, kw in K2_CASES.items():
        got[name] = tff.poly_expansion(t(img0), kw["n"], kw["sigma"], HP, WP,
                                       kw["blur"], kw["margin"]).numpy()
    got["inputs"] = (m, r0, r1, bsc)
    got["flow_in"] = (dx, dy)

    ref = {}
    bscp = np.pad(jff._border_scale_hw(HK, WK)[..., None],
                  [(0, HP - HK), (0, WP - WK), (0, 0)], mode="edge")
    dxj, dyj = np.moveaxis(dx, 0, -1), np.moveaxis(dy, 0, -1)
    r0j, r1j = _cm(r0.numpy()), _cm(r1.numpy())
    mj = _cm(m.float().numpy()).astype(jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        for name, kw in K2_CASES.items():
            ref[name] = _bm(jff._poly_expansion_cm_pallas(
                jnp.asarray(np.moveaxis(img0, 0, -1)), kw["n"], kw["sigma"], HP, WP,
                blur_kernel=kw["blur"], th=kw["th"], tw=kw["tw"],
                margin=kw["margin"]))
        ref["k3"] = _bm(jff._update_matrices_sep_cm(
            jnp.asarray(_pad_hw(dxj)), jnp.asarray(_pad_hw(dyj)), r0j,
            jnp.asarray(bscp), r1j, jnp.asarray(_pad_hw(dxj, E, E)), RADIUS,
            32, 32, out_dtype=jnp.bfloat16, r1_off=(8 - E, 8)))
        for emit in ("matrices", "flow"):
            ref[emit] = _bm(jff._fused_box_update_cm(
                mj, r0j, jnp.asarray(bscp), r1j, WINSIZE, RADIUS, emit, 32, 32,
                r1_off=(8 - E, 8)))
    return got, ref


@pytest.mark.parametrize("name", sorted(K2_CASES))
def test_poly_expansion_matches_pallas(case, name):
    got, ref = case
    assert got[name].shape == ref[name].shape
    # 0–255 images, expansion planes up to ~1e3: f32 rounding, ≤ 1e-4 abs.
    # At poly_n 1 the scales ig03 = −2.27 and ig33 = 4.06 (poly_n 5: −0.35,
    # 0.24) make a_yy and a_xx differences of terms up to ~1e3: their f32
    # rounding in XLA's order reaches 1.4e-4 there, held to 3e-4
    atol = K2_CASES[name].get("atol", 1e-4)
    np.testing.assert_allclose(got[name], ref[name], rtol=0, atol=atol)


def _assert_bf16_close(got, ref):
    """≥ 99 % of elements bit-equal; every element within one bf16 ulp of
    its reference value, or, where the five products cancel to below the
    channel's scale, within 1e-6 of the channel's largest magnitude (the
    f32 rounding of the cancelling terms: XLA's CPU code and this port
    round them at different places)."""
    assert got.shape == ref.shape
    gi = got.view(np.int32).astype(np.int64) >> 16
    ri = ref.view(np.int32).astype(np.int64) >> 16
    assert (gi == ri).mean() >= 0.99
    for c in range(ref.shape[1]):
        rc, gc = ref[:, c], got[:, c]
        ulp = np.spacing(np.abs(rc).astype(np.float32)) * 2.0**16
        tol = np.maximum(ulp, 1e-6 * np.abs(rc).max())
        assert (np.abs(gc - rc) <= tol).all(), c


def test_update_matrices_sep_matches_pallas(case):
    got, ref = case
    _assert_bf16_close(got["k3"], ref["k3"])


def test_fused_box_update_matrices_matches_pallas(case):
    got, ref = case
    _assert_bf16_close(got["matrices"], ref["matrices"])


def test_fused_box_update_flow_matches_pallas(case):
    got, ref = case
    assert got["flow"].shape == ref["flow"].shape == (B, 2, HP, WP)
    assert np.abs(got["flow"] - ref["flow"]).max() <= 1e-3


# K4 at other (winsize, radius) than the module's grasp pair, on the same
# level: M, r0, r1 and the border scale from the module's case
K4_CASES = {"tabletennis": (4, 5)}


@pytest.fixture(scope="module")
def k4_other(case):
    got, ref = {}, {}
    m, r0, r1, bsc = case[0]["inputs"]
    bscp = np.pad(jff._border_scale_hw(HK, WK)[..., None],
                  [(0, HP - HK), (0, WP - WK), (0, 0)], mode="edge")
    mj = _cm(m.float().numpy()).astype(jnp.bfloat16)
    r0j, r1j = _cm(r0.numpy()), _cm(r1.numpy())
    for name, (winsize, radius) in K4_CASES.items():
        for emit in ("matrices", "flow"):
            got[name, emit] = tff.fused_box_update(m, r0, r1, bsc, winsize, radius,
                                                   emit).float().numpy()
            with pltpu.force_tpu_interpret_mode():
                ref[name, emit] = _bm(jff._fused_box_update_cm(
                    mj, r0j, jnp.asarray(bscp), r1j, winsize, radius, emit, 32, 32,
                    r1_off=(8 - radius - 1, 8)))
    return got, ref


@pytest.mark.parametrize("emit", ["matrices", "flow"])
@pytest.mark.parametrize("name", sorted(K4_CASES))
def test_fused_box_update_matches_pallas_at(k4_other, name, emit):
    """K4 at tabletennis's winsize 4 / radius 5, held as at the grasp pair."""
    got, ref = k4_other
    if emit == "matrices":
        _assert_bf16_close(got[name, emit], ref[name, emit])
    else:
        assert got[name, emit].shape == ref[name, emit].shape == (B, 2, HP, WP)
        assert np.abs(got[name, emit] - ref[name, emit]).max() <= 1e-3


# K3 at other radii than the module's grasp radius, on the same level: the
# flow, r0, r1 and the border scale from the module's case
K3_RADII = {"tabletennis": 5}


@pytest.fixture(scope="module")
def k3_other(case):
    got, ref = {}, {}
    _, r0, r1, bsc = case[0]["inputs"]
    dx, dy = case[0]["flow_in"]
    bscp = np.pad(jff._border_scale_hw(HK, WK)[..., None],
                  [(0, HP - HK), (0, WP - WK), (0, 0)], mode="edge")
    dxj, dyj = np.moveaxis(dx, 0, -1), np.moveaxis(dy, 0, -1)
    r0j, r1j = _cm(r0.numpy()), _cm(r1.numpy())
    t = torch.from_numpy
    for name, radius in K3_RADII.items():
        e = radius + 1
        got[name] = tff.update_matrices_sep(t(dx), t(dy), r0, r1, bsc,
                                            radius).float().numpy()
        with pltpu.force_tpu_interpret_mode():
            ref[name] = _bm(jff._update_matrices_sep_cm(
                jnp.asarray(_pad_hw(dxj)), jnp.asarray(_pad_hw(dyj)), r0j,
                jnp.asarray(bscp), r1j, jnp.asarray(_pad_hw(dxj, e, e)), radius,
                32, 32, out_dtype=jnp.bfloat16, r1_off=(8 - e, 8)))
    return got, ref


@pytest.mark.parametrize("name", sorted(K3_RADII))
def test_update_matrices_sep_matches_pallas_at(k3_other, name):
    """K3 at tabletennis's warp radius 5, held as at the grasp radius."""
    got, ref = k3_other
    _assert_bf16_close(got[name], ref[name])


@pytest.mark.parametrize("shape,taps", [((3, 37, 45), 5), ((2, 33, 61), 7),
                                        ((4, 31, 29), 3)])
def test_blur_valid_matches_jax(shape, taps):
    rng = np.random.default_rng(taps)
    img = rng.random(shape).astype(np.float32)
    k = _gaussian_blur_kernel(taps, 0.9)
    n = taps // 2
    xp = np.pad(img, [(0, 0), (n, n), (n, n)], mode="reflect")
    ref = np.moveaxis(np.asarray(jff._blur_valid(
        jnp.asarray(np.moveaxis(xp, 0, -1)), k)), -1, 0)
    got = tff._blur_valid(tff._reflect_pad(torch.from_numpy(img), n), k).numpy()
    # unit-range image: f32 sums in another order, ≤ 1e-5
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("src,dst", [((37, 45), (19, 23)), ((19, 23), (37, 45)),
                                     ((33, 61), (66, 122)), ((31, 29), (16, 14))])
def test_resize_matches_jax(src, dst):
    rng = np.random.default_rng(src[0])
    img = rng.random((3,) + src).astype(np.float32)
    ref = np.moveaxis(np.asarray(jff._resize_hwb(
        jnp.asarray(np.moveaxis(img, 0, -1)), *dst)), -1, 0)
    got = tff._resize_hwb(torch.from_numpy(img), *dst).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_any_batch_size():
    rng = np.random.default_rng(7)
    img = (rng.random((3, 48, 70)) * 255).astype(np.uint8)
    flow = tff.farneback_fast(img, np.roll(img, 1, axis=2), FarnebackParams(), 3,
                              device="cpu")
    assert flow.shape == (3, 48, 70, 2) and torch.isfinite(flow).all()
