"""The slice as a whole on the uav preset: the level route (K5 + K6) through
``seg_batch_fast``, against the JAX package's.

``nsof_tpu_torch.pipelines.segmentation.seg_batch_fast(..., device='cpu',
return_flow=True)`` against ``nsof_tpu.pipelines.segmentation.
seg_batch_fast(kernel_mode='fused', return_flow=True)`` with its Pallas
kernels in TPU interpret mode.  The uav preset (poly_n 10, winsize 3,
pyr_scale 0.6) leaves the fused route for 'pallas_sep' in both packages.
It is cut to 96×128 frames, memsize 32 (a 3×4 state grid) and a 96×128
window (levels 0–2); warp radius 3, B = 128, inputs made with numpy from a
seed in the style of bench.py.

Measured here: box and any_active exact; region_pct within one float32 ulp
of the jitted JAX path; flow max 1.4e-2 px, mean 1.5e-6 px, 99.99 % of the
flow values within 1e-3 px; masks 100 % equal.  The flow's max is looser
than the fused route's 1e-2 (``tests/test_torch_segmentation.py``):
winsize 3 and the border attenuation leave the 2×2 systems of a few pixels
near the frame's top rows ill-conditioned, and f32 rounding differences of
a few ulp grow there over 3 levels × 3 iterations.  With the JAX package's
own expansion and blur fed into the port, the same pixel is still 7.7e-3 px
apart, so the rest comes from the kernels' last bits (XLA's fused CPU code
in interpret mode rounds some elsewhere).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

from nsof_tpu.config import DATASETS
from nsof_tpu.pipelines import segmentation as jseg
from nsof_tpu_torch.config import config_from_dict
from nsof_tpu_torch.ops import farneback_fast as tff
from nsof_tpu_torch.pipelines import segmentation as tseg

H, W, MEMSIZE, B = 96, 128, 32, 128


def _cfg():
    cfg = dataclasses.replace(DATASETS["uav"], name="uav96", image_h=H, image_w=W,
                              window_h=H, window_w=W)
    return dataclasses.replace(cfg, roi=dataclasses.replace(cfg.roi, memsize=MEMSIZE))


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    base = rng.random((H + 64, W + 64)).astype(np.float32) * 255
    prev = np.stack([base[16 + v % 5 : 16 + v % 5 + H, 16 : 16 + W]
                     for v in range(B)]).astype(np.uint8)
    nxt = np.stack([base[18 + v % 5 : 18 + v % 5 + H, 15 : 15 + W]
                    for v in range(B)]).astype(np.uint8)
    mem = np.zeros((B, H // MEMSIZE, W // MEMSIZE), np.uint8)
    for i in range(B):
        y, x = rng.integers(0, 2), rng.integers(0, 3)
        mem[i, y : y + 2, x : x + 2] = 255
    mem[0] = 0  # no active cell
    mem[1] = 255  # saturated: the ROI is the whole frame
    return mem, prev, nxt


@pytest.fixture(scope="module")
def runs():
    cfg = _cfg()
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    mem, prev, nxt = _inputs()
    got = tseg.seg_batch_fast(mem, prev, nxt, tcfg, return_flow=True, device="cpu")
    got = {k: v.numpy() for k, v in got.items()}
    with pltpu.force_tpu_interpret_mode():
        ref = jseg.seg_batch_fast(jnp.asarray(mem), jnp.asarray(prev),
                                  jnp.asarray(nxt), cfg, kernel_mode="fused",
                                  return_flow=True)
        ref = {k: np.array(v) for k, v in ref.items()}
    return tcfg, got, ref


def test_route_is_pallas_sep(runs):
    tcfg, _, _ = runs
    assert tff.route("auto", tcfg.fb) == tff.route("fused", tcfg.fb) == "pallas_sep"


def test_roi_outputs_exact(runs):
    _, got, ref = runs
    for key in ("box", "any_active"):
        np.testing.assert_array_equal(got[key], ref[key], key)
    assert not got["any_active"][0] and got["any_active"][1:].all()
    np.testing.assert_array_max_ulp(got["region_pct"], ref["region_pct"], maxulp=1)


def test_flow_close(runs):
    """Flow ≤ 2e-2 px max, ≤ 5e-4 px mean, ≥ 99.9 % within 1e-3 px."""
    _, got, ref = runs
    assert got["flow"].shape == ref["flow"].shape == (B, H, W, 2)
    err = np.abs(got["flow"] - ref["flow"])
    assert err.max() <= 2e-2
    assert err.mean() <= 5e-4
    assert (err <= 1e-3).mean() >= 0.999


def test_mask_agrees(runs):
    _, got, ref = runs
    assert got["mask"].shape == (B, H, W) and got["mask"].dtype == np.uint8
    assert (got["mask"] == ref["mask"]).mean() >= 0.995
    assert (ref["mask"] > 0).any()
