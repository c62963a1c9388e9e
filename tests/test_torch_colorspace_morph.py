"""The port's colour-space ops and morphology against the JAX package's.

Colour: ``hsv_to_bgr_u8`` over all 180·256·256 HSV triples, the gray
conversions over all 256³ triples and ``threshold_binary`` over every
uint8 value, bit for bit against the JAX functions run op by op (as
written: under ``jax.jit`` XLA fuses products into adds and turns
divisions by constants into products, ROADMAP queue 3); ``cart_to_polar``
on random and axis-aligned flows.  Morphology: binary and grayscale ops
with the 10×10 and 3×3 ellipses (and a 5×7 one), on random masks and
images made with numpy from a seed, foreground touching every border.

Measured here (21 tests): every colour op and every morphology op equal
bit for bit; ``cart_to_polar``'s magnitude equal bit for bit (its square
root taken in float64, since PyTorch's float32 sqrt on the CPU is one ulp
off for 0.7 % of these inputs), its angle within 1 float32 ulp of XLA's
atan2 (one ulp apart at 10.9 % of the random flows, eager or jitted).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsof_tpu.ops import colorspace as jcs
from nsof_tpu.ops import morphology as jm
from nsof_tpu_torch.ops import colorspace as tcs
from nsof_tpu_torch.ops import morphology as tm


def _eq(got: torch.Tensor, ref):
    ref = np.asarray(ref)
    assert got.dtype == torch.from_numpy(np.zeros(1, ref.dtype)).dtype
    np.testing.assert_array_equal(got.numpy(), ref)


def test_hsv_to_bgr_all_triples():
    h, s, v = np.meshgrid(np.arange(180), np.arange(256), np.arange(256), indexing="ij")
    hsv = np.stack([h, s, v], -1).astype(np.uint8)
    _eq(tcs.hsv_to_bgr_u8(torch.from_numpy(hsv)), jcs.hsv_to_bgr_u8(jnp.asarray(hsv)))


@pytest.mark.parametrize("name", ["bgr_to_gray_u8", "rgb_to_gray_u8"])
def test_gray_all_triples(name):
    c = np.arange(256, dtype=np.uint8)
    img = np.stack(np.meshgrid(c, c, c, indexing="ij"), -1)
    _eq(getattr(tcs, name)(torch.from_numpy(img)), getattr(jcs, name)(jnp.asarray(img)))


@pytest.mark.parametrize("thresh,maxval", [(1, 255), (127, 256), (0.5, 100), (254, 255)])
def test_threshold_binary_every_value(thresh, maxval):
    x = np.arange(256, dtype=np.uint8).reshape(16, 16)
    _eq(tcs.threshold_binary(torch.from_numpy(x), thresh, maxval),
        jcs.threshold_binary(jnp.asarray(x), thresh, maxval))


def test_u8_casts_and_normalize():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-20, 280, 10_000),
                        np.arange(-3, 259) + 0.5]).astype(np.float32)
    for name in ("saturate_u8", "trunc_u8"):
        _eq(getattr(tcs, name)(torch.from_numpy(x)), getattr(jcs, name)(jnp.asarray(x)))
    for arr in (x, np.full(7, 3.0, np.float32)):
        _eq(tcs.normalize_minmax(torch.from_numpy(arr)), jcs.normalize_minmax(jnp.asarray(arr)))


def test_cart_to_polar_and_hsv_image():
    """Magnitude bit for bit, angle within 1 ulp of XLA's atan2; the HSV
    image of the JAX polar coordinates bit for bit."""
    rng = np.random.default_rng(1)
    fx = rng.normal(0, 3, 20_000).astype(np.float32)
    fy = rng.normal(0, 3, 20_000).astype(np.float32)
    axes = np.array([0.0, -0.0, 1.0, -1.0, 2.5], np.float32)
    fx = np.concatenate([fx, np.repeat(axes, 5)])
    fy = np.concatenate([fy, np.tile(axes, 5)])
    mag, ang = tcs.cart_to_polar(torch.from_numpy(fx), torch.from_numpy(fy))
    jmag, jang = jcs.cart_to_polar(jnp.asarray(fx), jnp.asarray(fy))
    _eq(mag, jmag)
    np.testing.assert_array_max_ulp(ang.numpy(), np.asarray(jang), maxulp=1)
    assert ((ang.numpy() >= 0) & (ang.numpy() < 2 * np.pi)).all()
    _eq(tcs.flow_to_hsv_u8(torch.from_numpy(np.array(jmag)),
                           torch.from_numpy(np.array(jang))),
        jcs.flow_to_hsv_u8(jmag, jang))


def _masks(seed, shape=(3, 40, 52), p=0.8):
    rng = np.random.default_rng(seed)
    m = (rng.random(shape) > p).astype(np.uint8) * 255
    m[0, 0, :] = m[0, :, 0] = m[1, -1, :] = m[1, :, -1] = 255  # on every border
    m[2, :5, :7] = 255  # a block in the corner
    return m


SES = {"10x10": (10, 10), "3x3": (3, 3), "5x7": (5, 7)}


@pytest.mark.parametrize("se", sorted(SES))
@pytest.mark.parametrize("name", ["dilate_binary", "erode_binary", "morph_close"])
def test_binary_morphology_bit_exact(name, se):
    se_np = tm.ellipse_se(*SES[se])
    np.testing.assert_array_equal(se_np, jm.ellipse_se(*SES[se]))
    masks = _masks(2)
    got = getattr(tm, name)(torch.from_numpy(masks), se_np)
    ref = np.stack([np.asarray(getattr(jm, name)(jnp.asarray(m), se_np)) for m in masks])
    _eq(got, ref)


def test_seg_loop_bit_exact():
    se = tm.ellipse_se(10, 10)
    masks = _masks(3, (3, 60, 80), p=0.9)
    got = tm.dilate_erode_n(torch.from_numpy(masks), se, 5)
    ref = np.stack([np.asarray(jm.dilate_erode_n(jnp.asarray(m), se, 5)) for m in masks])
    _eq(got, ref)


@pytest.mark.parametrize("se", ["3x3", "10x10"])
def test_gray_morphology_bit_exact(se):
    se_np = tm.ellipse_se(*SES[se])
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (3, 33, 47)).astype(np.uint8)
    img[0, 0, :] = 255
    img[1, :, -1] = 0
    for name in ("dilate_gray", "erode_gray", "morph_close_gray"):
        got = getattr(tm, name)(torch.from_numpy(img), se_np)
        ref = np.stack([np.asarray(getattr(jm, name)(jnp.asarray(i), se_np)) for i in img])
        _eq(got, ref)
