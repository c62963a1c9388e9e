"""The level route's kernels, K5–K7, and its expansion against the JAX
package, its Pallas kernels run in TPU interpret mode.

Plain versions (what the kernel wrappers run on a CPU tensor) against
``update_matrices_pallas(separable=True)`` (K5), ``box_solve_pallas`` (K6),
``update_matrices_pallas(separable=False)`` and ``update_matrices_fast``
(K7) and ``poly_expansion_fast``.  Inputs: a 40×50 level, B = 128, so the
JAX drivers reach their Pallas kernels and not their ``B % 128`` XLA
fallbacks, made with numpy from a seed.

Measured here: the expansion within 3.1e-5 (poly_n 5) and 3.8e-5 (poly_n
10) of ``poly_expansion_fast`` on 0–255 images (XLA's convolution sums the
taps in another order); K5 and K7 within 3.4e-7 of their channel's largest
magnitude of the Pallas kernels, 56–59 % bit-equal (the interpret-mode
kernel runs through XLA's fused CPU code, which rounds some last bits
elsewhere); K7 bit-equal to ``update_matrices_fast``; K6 within 5.3e-6 px
(winsize 3), 9.6e-7 px (15) and 1.2e-6 px (21, where the JAX driver sums
with ``_box_sum_dw`` instead of its kernel).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from chip_smoke import k7_flow
from nsof_tpu.ops import farneback_fast as jff
from nsof_tpu_torch.ops import farneback_fast as tff

B, H, W = 128, 40, 50


def _to_hwbc(x):
    """[B, C, H, W] → the JAX fast path's [H, W, B, C]."""
    return jnp.asarray(np.ascontiguousarray(np.moveaxis(x, (0, 1), (2, 3))))


def _from_hwbc(x):
    return np.moveaxis(np.asarray(x), (2, 3), (0, 1))


def _hwb(x):
    return jnp.asarray(np.ascontiguousarray(np.moveaxis(x, 0, -1)))


@pytest.fixture(scope="module")
def level():
    rng = np.random.default_rng(0)
    img0 = (rng.random((B, H, W)) * 255).astype(np.float32)
    img1 = (rng.random((B, H, W)) * 255).astype(np.float32)
    coarse = rng.normal(size=(B, 2, H // 8 + 2, W // 8 + 2)).astype(np.float32) * 2.5
    flow = torch.nn.functional.interpolate(
        torch.from_numpy(coarse), size=(H, W), mode="bilinear").numpy()
    dx, dy = np.ascontiguousarray(flow[:, 0]), np.ascontiguousarray(flow[:, 1])
    r0 = tff.poly_expansion_fast(torch.from_numpy(img0), 5, 1.2)
    r1 = tff.poly_expansion_fast(torch.from_numpy(img1), 5, 1.2)
    return dict(img0=img0, dx=dx, dy=dy, r0=r0, r1=r1,
                bsc=tff.border_scale(H, W, "cpu"))


def _jax_update(level, radius, separable):
    flow = jnp.stack([_hwb(level["dx"]), _hwb(level["dy"])], axis=-1)
    args = (_to_hwbc(level["r0"].numpy()), _to_hwbc(level["r1"].numpy()), flow, radius)
    with pltpu.force_tpu_interpret_mode():
        pallas = _from_hwbc(jff.update_matrices_pallas(*args, separable=separable))
    return pallas, _from_hwbc(jff.update_matrices_fast(*args))


def _port_update(level, radius, separable):
    e = radius + 1
    r1p = tff._extend(level["r1"], e, e, e, e)
    return tff.update_matrices(torch.from_numpy(level["dx"]), torch.from_numpy(level["dy"]),
                               level["r0"], r1p, level["bsc"], radius,
                               separable=separable).numpy()


def _assert_m_close(got, ref):
    """float32 M: every element within 1e-6 of its channel's largest
    magnitude."""
    assert got.shape == ref.shape == (B, 5, H, W) and got.dtype == np.float32
    chmax = np.abs(ref).max(axis=(0, 2, 3), keepdims=True)
    assert (np.abs(got - ref) <= 1e-6 * chmax).all()


@pytest.mark.parametrize("n,sigma", [(5, 1.2), (10, 1.05)])
def test_poly_expansion_fast_matches_jax(level, n, sigma):
    img = level["img0"]
    ref = _from_hwbc(jff.poly_expansion_fast(_hwb(img), n, sigma))
    got = tff.poly_expansion_fast(torch.from_numpy(img), n, sigma).numpy()
    assert got.shape == ref.shape == (B, 5, H, W)
    # 0–255 images, planes up to ~70: f32 sums in another order, ≤ 1e-4
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("radius", [3, 5])  # the TPU halos 4 and 8
def test_update_matrices_sep_matches_pallas(level, radius):
    """K5's plain version against update_matrices_pallas(separable=True)."""
    ref, _ = _jax_update(level, radius, True)
    _assert_m_close(_port_update(level, radius, True), ref)


@pytest.mark.parametrize("radius", [3, 5])
def test_update_matrices_matches_pallas_and_fast(level, radius):
    """K7's plain version against update_matrices_pallas(separable=False),
    and bit for bit against update_matrices_fast (same sum order)."""
    ref, fast = _jax_update(level, radius, False)
    got = _port_update(level, radius, False)
    _assert_m_close(got, ref)
    np.testing.assert_array_equal(got, fast)


def _warp_four_taps(dx, dy, r0, r1p, bsc, radius):
    """K7's sum as its CUDA kernel takes it: per pixel only the taps at
    ky0 = floor(dy), ky0 + 1 and kx0 = floor(dx), kx0 + 1 of the clamped
    flow, gathered from the padded r1 and added from 0 in the order (ky0,
    kx0), (ky0, kx0 + 1), (ky0 + 1, kx0), (ky0 + 1, kx0 + 1)."""
    b, _, h, w = r0.shape
    pad = (r1p.shape[-1] - w) // 2
    w1 = w + 2 * pad
    dxc, dyc = dx.clamp(-radius, radius), dy.clamp(-radius, radius)
    ky0, kx0 = dyc.floor(), dxc.floor()
    rows = torch.arange(h)[:, None] + pad + ky0.long()
    cols = torch.arange(w) + pad + kx0.long()
    flat = r1p.reshape(b, 5, -1)
    acc = torch.zeros_like(r0)
    for a in (0, 1):
        wy = tff._hat(dyc, ky0 + a)
        for c in (0, 1):
            idx = ((rows + a) * w1 + cols + c).reshape(b, 1, -1).expand(b, 5, -1)
            tap = flat.gather(2, idx).reshape(b, 5, h, w)
            acc = acc + tap * (wy * tff._hat(dxc, kx0 + c))[:, None]
    return tff._build_system(r0, acc, dxc, dyc, bsc, torch.float32)


@pytest.mark.parametrize("radius", [1, 3, 8])
def test_four_tap_warp_matches_full_sum(radius):
    """The four-tap sum of K7's kernel equals the (2r+2)²-tap sum bit for
    bit, both the plain version's and update_matrices_fast's, at flows where
    they could part (chip_smoke.k7_flow: integers, ±r and beyond, ±0, tiny
    values, one ulp either side of each integer)."""
    b, h, w, e = 4, 37, 53, radius + 1
    rng = np.random.default_rng(radius)
    dx, dy = k7_flow((b, h, w), radius, rng), k7_flow((b, h, w), radius, rng)
    r0 = (rng.normal(size=(b, 5, h, w)) * 50.0).astype(np.float32)
    r1 = (rng.normal(size=(b, 5, h, w)) * 50.0).astype(np.float32)
    args = (torch.from_numpy(dx), torch.from_numpy(dy), torch.from_numpy(r0),
            tff._extend(torch.from_numpy(r1), e, e, e, e), tff.border_scale(h, w, "cpu"),
            radius)
    got = _warp_four_taps(*args).numpy()
    flow = jnp.stack([_hwb(dx), _hwb(dy)], axis=-1)
    fast = _from_hwbc(jff.update_matrices_fast(_to_hwbc(r0), _to_hwbc(r1), flow, radius))
    for ref in (tff._warp_full(*args).numpy(), fast):
        np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_update_matrices_refuses_short_pad():
    """K5 and K7 need r1 padded by radius + 1: one less raises."""
    b, h, w, r = 1, 9, 11, 3
    z = torch.zeros((b, h, w))
    r1p = torch.zeros((b, 5, h + 2 * r, w + 2 * r))
    for separable in (False, True):
        with pytest.raises(ValueError, match="radius"):
            tff.update_matrices(z, z, torch.zeros((b, 5, h, w)), r1p,
                                tff.border_scale(h, w, "cpu"), r, separable=separable)


@pytest.mark.parametrize("winsize", [3, 15, 21])  # 21: m = 10 > the kernel's 8
def test_box_solve_matches_pallas(level, winsize):
    """K6's plain version against box_solve_pallas: ≤ 2e-5 px."""
    m = tff.update_matrices(torch.from_numpy(level["dx"]), torch.from_numpy(level["dy"]),
                            level["r0"], tff._extend(level["r1"], 4, 4, 4, 4),
                            level["bsc"], 3, separable=True)
    with pltpu.force_tpu_interpret_mode():
        ref = np.moveaxis(np.asarray(jff.box_solve_pallas(_to_hwbc(m.numpy()), winsize)),
                          (2, 3), (0, 1))
    dx, dy = tff.box_solve(m, winsize)
    got = np.stack([dx.numpy(), dy.numpy()], axis=1)
    assert got.shape == ref.shape == (B, 2, H, W)
    assert np.abs(got - ref).max() <= 2e-5


def test_poly_expansion_plain_at_poly_n_10(level):
    """K2's plain version at autodriving's poly_n 10 and poly_sigma 1.05
    (the generic kernel instance's arithmetic, centre tap first) against
    the JAX package: its Pallas wrapper refuses poly_n 10 (its halo holds
    n + blur ≤ 8 rows), so it is held against ``poly_expansion_fast``, on
    the image's extent and on a canvas 8 rows and 14 columns larger (whose
    image part is the same).  Measured here: within 3.8e-5 on 0–255
    images (planes up to ~70)."""
    img = level["img0"][:16]
    with pltpu.force_tpu_interpret_mode(), pytest.raises(AssertionError):
        jff._poly_expansion_cm_pallas(_hwb(img), 10, 1.05, H, W)
    ref = np.moveaxis(np.asarray(jff.poly_expansion_fast(_hwb(img), 10, 1.05)), (2, 3), (0, 1))
    for hp, wp in ((H, W), (H + 8, W + 14)):
        got = tff._poly_expansion_plain(torch.from_numpy(img), 10, 1.05, hp, wp).numpy()
        assert got.shape == (16, 5, hp, wp)
        np.testing.assert_allclose(got[..., :H, :W], ref, rtol=0, atol=1e-4)
