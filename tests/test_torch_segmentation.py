"""The port's main path as a whole against the JAX package's.

``nsof_tpu_torch.pipelines.segmentation.seg_batch_fast(..., device='cpu',
return_flow=True)`` against ``nsof_tpu.pipelines.segmentation.
seg_batch_fast(kernel_mode='fused', return_flow=True)`` with its Pallas
kernels in TPU interpret mode: 240×320 frames, memsize 40 (a 6×8 state
grid), a 128×128 window (levels 0–2, so the pyramid cascade is covered),
the grasp preset at warp radius 3, B = 128, inputs made with numpy from a
seed in the style of bench.py.

Measured here: box and any_active exact; region_pct exact against the JAX
function as written, and within one float32 ulp of the jitted JAX path
(XLA turns the division by H·W into a product); flow max 3.9e-3 px, mean
1.5e-5 px; masks 100 % equal; the port's head fed the JAX flow reproduces
the JAX mask bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nsof_tpu.config import DATASETS
from nsof_tpu.ops import roi as jroi
from nsof_tpu.pipelines import segmentation as jseg
from nsof_tpu_torch.config import config_from_dict
from nsof_tpu_torch.ops import roi as troi
from nsof_tpu_torch.pipelines import segmentation as tseg

H, W, MEMSIZE, B = 240, 320, 40, 128
WIN = 128


def _cfg():
    cfg = dataclasses.replace(
        DATASETS["grasp"], name="test240", image_h=H, image_w=W,
        window_h=WIN, window_w=WIN, warp_radius=3,
    )
    return dataclasses.replace(
        cfg, roi=dataclasses.replace(cfg.roi, memsize=MEMSIZE)
    )


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    base = rng.random((H + 64, W + 64)).astype(np.float32) * 255
    prev = np.stack([base[16 + v % 5 : 16 + v % 5 + H, 16 : 16 + W]
                     for v in range(B)]).astype(np.uint8)
    nxt = np.stack([base[18 + v % 5 : 18 + v % 5 + H, 15 : 15 + W]
                    for v in range(B)]).astype(np.uint8)
    mem = np.zeros((B, H // MEMSIZE, W // MEMSIZE), np.uint8)
    for i in range(B):
        y, x = rng.integers(0, 5), rng.integers(0, 7)
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
    return cfg, tcfg, got, ref


def test_roi_outputs_exact(runs):
    cfg, _, got, ref = runs
    for key in ("box", "any_active"):
        np.testing.assert_array_equal(got[key], ref[key], key)
    assert not got["any_active"][0] and got["any_active"][1:].all()
    eager = jax.vmap(lambda bx: jroi.region_percentage(bx, H, W))(jnp.asarray(ref["box"]))
    np.testing.assert_array_equal(got["region_pct"], np.asarray(eager))
    # the jitted JAX path computes area·(100/(H·W)) in float32
    np.testing.assert_array_max_ulp(got["region_pct"], ref["region_pct"], maxulp=1)


def test_flow_close(runs):
    _, _, got, ref = runs
    assert got["flow"].shape == ref["flow"].shape == (B, H, W, 2)
    err = np.abs(got["flow"] - ref["flow"])
    assert err.max() <= 1e-2
    assert err.mean() <= 5e-4


def test_mask_agrees(runs):
    _, _, got, ref = runs
    assert got["mask"].shape == (B, H, W) and got["mask"].dtype == np.uint8
    assert (got["mask"] == ref["mask"]).mean() >= 0.995
    assert (ref["mask"] > 0).any()
    acc = tseg.pixel_accuracy(torch.from_numpy(got["mask"]), torch.from_numpy(ref["mask"]))
    np.testing.assert_allclose(
        float(acc),
        float(jseg.pixel_accuracy(jnp.asarray(got["mask"]), jnp.asarray(ref["mask"]))),
        rtol=1e-6)


def test_head_on_jax_flow_bit_exact(runs):
    """The port's head and scatter, fed the JAX flow, give the JAX mask."""
    _, tcfg, _, ref = runs
    box = torch.from_numpy(ref["box"])
    oys, oxs = troi.window_origin(box, WIN, WIN, H, W)
    flow_win = troi.crop_windows_batch(torch.from_numpy(ref["flow"]), oys, oxs, WIN, WIN)
    inbox = troi.window_box_mask(box, oys, oxs, WIN, WIN)
    inbox &= torch.from_numpy(ref["any_active"])[:, None, None]
    mask_win = tseg.seg_head_window_batch(flow_win, inbox, tcfg)
    mask = troi.scatter_window(torch.zeros((B, H, W), dtype=torch.uint8), mask_win,
                               box, oys, oxs)
    np.testing.assert_array_equal(mask.numpy(), ref["mask"])
