"""``farneback_fast``'s routes: which one each ``kernel_mode`` and preset
takes, and the level route 'pallas' end to end against the JAX package
(its Pallas kernels in TPU interpret mode).

Inputs: a texture shifted between the frames by (dx, dy) = (+1, −2) px,
made with numpy from a seed, uav preset (poly_n 10, winsize 3), warp
radius 3.  'pallas' runs at 64×96, B = 128, so the JAX driver reaches its
kernels K7 and K6.

Measured here: 'pallas' flow max 4.4e-4 px, mean 8.3e-7 px.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nsof_tpu.ops import farneback_fast as jff
from nsof_tpu.ops.farneback import PRESETS as JAX_PRESETS
from nsof_tpu_torch.ops import farneback_fast as tff
from nsof_tpu_torch.ops.farneback import PRESETS, FarnebackParams
from nsof_tpu_torch.pipelines.segmentation import seg_batch_fast

RADIUS = 3


def shifted_pair(b, h, w, seed=0):
    """A random texture and the same texture shifted by (dx, dy) = (+1, −2)
    px (bench.py's crops), varied over the batch."""
    rng = np.random.default_rng(seed)
    base = rng.random((h + 64, w + 64)).astype(np.float32) * 255
    prev = np.stack([base[16 + v % 5 : 16 + v % 5 + h, 16 : 16 + w]
                     for v in range(b)]).astype(np.uint8)
    nxt = np.stack([base[18 + v % 5 : 18 + v % 5 + h, 15 : 15 + w]
                    for v in range(b)]).astype(np.uint8)
    return prev, nxt


def test_pallas_route_matches_jax():
    """'pallas' (K7 + K6) end to end: flow ≤ 5e-3 px max, ≤ 1e-5 px mean."""
    b, h, w = 128, 64, 96
    prev, nxt = shifted_pair(b, h, w)
    got = tff.farneback_fast(prev, nxt, PRESETS["uav"], RADIUS, "pallas",
                             device="cpu").numpy()
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jff.farneback_fast(jnp.asarray(prev), jnp.asarray(nxt),
                                            JAX_PRESETS["uav"], RADIUS, "pallas"))
    assert got.shape == ref.shape == (b, h, w, 2)
    err = np.abs(got - ref)
    assert err.max() <= 5e-3
    assert err.mean() <= 1e-5


@pytest.mark.parametrize("mode,preset,want", [
    ("auto", "grasp", "fused"),
    ("auto", "tabletennis", "fused"),
    ("auto", "uav", "pallas_sep"),
    ("auto", "autodriving", "pallas_sep"),
    ("fused", "uav", "pallas_sep"),
    ("fused_f32", "grasp", "fused_f32"),
    ("fused_f32", "autodriving", "pallas_sep"),
    ("pallas_sep", "grasp", "pallas_sep"),
    ("pallas", "uav", "pallas"),
    ("xla", "grasp", "xla"),
])
def test_route(mode, preset, want):
    """The JAX package's routing on the TPU, batch size aside."""
    assert tff.route(mode, PRESETS[preset]) == want


def test_route_winsize_beyond_fused_halo():
    assert tff.route("auto", FarnebackParams(winsize=19)) == "pallas_sep"
    assert tff.route("auto", FarnebackParams(winsize=17)) == "fused"


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="kernel_mode"):
        tff.route("triton", FarnebackParams())


def test_defaults_are_auto():
    for fn in (tff.farneback_fast, seg_batch_fast):
        assert inspect.signature(fn).parameters["kernel_mode"].default == "auto"


@pytest.mark.parametrize("mode", ["pallas_sep", "pallas", "xla"])
def test_level_routes_any_batch_size(mode):
    prev, nxt = shifted_pair(3, 48, 70, seed=7)
    dx, dy = tff.farneback_fast(prev, nxt, PRESETS["uav"], RADIUS, mode,
                                out_layout="planes", device="cpu")
    assert dx.shape == dy.shape == (3, 48, 70)
    assert torch.isfinite(dx).all() and torch.isfinite(dy).all()
    # the texture moves by (+1, −2) px: the flow's median says so
    assert abs(float(dx.median()) - 1.0) < 0.2 and abs(float(dy.median()) + 2.0) < 0.2


def test_box_solve_wide_window_matches_direct_sum():
    """K6's plain version beyond the TPU kernel's m ≤ 8: its log-tree sums
    against a direct float64 box sum and solve, ≤ 1e-4 px."""
    rng = np.random.default_rng(3)
    m = rng.normal(size=(2, 5, 30, 41)).astype(np.float32)
    m[:, 0] = np.abs(m[:, 0]) + 1.0  # a well-conditioned system
    m[:, 2] = np.abs(m[:, 2]) + 1.0
    winsize = 21
    mm = winsize // 2
    me = np.pad(m.astype(np.float64), [(0, 0), (0, 0), (mm, mm), (mm, mm)], mode="edge")
    g = sum(me[:, :, i : i + 30, j : j + 41] for i in range(2 * mm + 1)
            for j in range(2 * mm + 1)) / winsize**2
    g11, g12, g22, h1, h2 = (g[:, c] for c in range(5))
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    dx, dy = tff.box_solve(torch.from_numpy(m), winsize)
    np.testing.assert_allclose(dx.numpy(), (g11 * h2 - g12 * h1) * idet, atol=1e-4)
    np.testing.assert_allclose(dy.numpy(), (g22 * h1 - g12 * h2) * idet, atol=1e-4)


def test_update_matrices_rejects_a_short_pad():
    r0 = torch.zeros((1, 5, 20, 30))
    r1p = torch.zeros((1, 5, 26, 36))  # pad 3 < radius + 1
    flow = torch.zeros((1, 20, 30))
    with pytest.raises(ValueError, match="radius"):
        tff.update_matrices(flow, flow, r0, r1p, tff.border_scale(20, 30, "cpu"), 3)
