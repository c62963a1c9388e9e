"""The port's warp, SSIM and prediction head against the JAX package's.

``remap_bilinear`` and ``warp_region`` on uint8 (gray and BGR) and float
images at random maps that leave the image, bit for bit against the JAX
functions run op by op (under ``jax.jit`` XLA fuses the bilinear products
into adds); ``ssim`` within 1e-5; ``prediction_batch_fast`` with
``kernel_mode='xla'`` on both sides (warp radius 1: the JAX route's compile
time grows with its (2r+2)² taps), ``prediction_step``, and the stages and
``prediction_step_full`` fed the same flows, against the jitted JAX
functions,
on ``tests/test_torch_seg_dual.py``'s 120×160 grasp cut (64×96 window)
with a uint8 BGR next frame made from the texture.

Measured here (7 tests): remap and warp_region equal bit for bit; SSIM
within 1.2e-7 of the JAX value; flows within 1.7e-6 px; ``pred`` equal
bit for bit to the op-by-op JAX warp of the same flow, and to the jitted
JAX path's but at 2 of ``prediction_batch_fast``'s 230,400 values, one
level apart (XLA fuses the jitted remap's products into adds).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsof_tpu.ops import ssim as jssim
from nsof_tpu.ops import warp as jwarp
from nsof_tpu.pipelines import prediction as jpred
from nsof_tpu_torch.config import config_from_dict
from nsof_tpu_torch.ops import ssim as tssim
from nsof_tpu_torch.ops import warp as twarp
from nsof_tpu_torch.pipelines import prediction as tpred
from tests.test_torch_seg_dual import H, W, small_cfg, small_inputs


def _bgr(prev_gray: np.ndarray, seed: int) -> np.ndarray:
    """A uint8 BGR frame from the gray texture: three channels mixed with
    a per-channel offset."""
    rng = np.random.default_rng(seed)
    off = rng.integers(0, 40, 3)
    return np.stack([(prev_gray.astype(np.int32) * (3 + c) // 4 + off[c]) % 256
                     for c in range(3)], -1).astype(np.uint8)


def _maps(rng, b, h, w):
    mx = (np.arange(w)[None, None] + rng.normal(0, 4, (b, h, w))).astype(np.float32)
    my = (np.arange(h)[None, :, None] + rng.normal(0, 4, (b, h, w))).astype(np.float32)
    mx[:, 0, :5] = [-3.5, -0.5, w - 0.5, w + 2.25, 0.5]  # beyond every border
    return mx, my


@pytest.mark.parametrize("kind", ["gray", "bgr", "float"])
def test_remap_bilinear_bit_exact(kind):
    rng = np.random.default_rng(len(kind))
    b, h, w = 3, 30, 41
    img = rng.integers(0, 256, (b, h, w, 3) if kind == "bgr" else (b, h, w))
    img = img.astype(np.float32 if kind == "float" else np.uint8)
    mx, my = _maps(rng, b, h, w)
    got = twarp.remap_bilinear(torch.from_numpy(img), torch.from_numpy(mx),
                               torch.from_numpy(my)).numpy()
    ref = np.stack([np.asarray(jwarp.remap_bilinear(jnp.asarray(i), jnp.asarray(x),
                                                    jnp.asarray(y)))
                    for i, x, y in zip(img, mx, my)])
    assert got.dtype == img.dtype
    np.testing.assert_array_equal(got, ref)


def test_warp_region_bit_exact():
    rng = np.random.default_rng(3)
    b = 3
    frame = np.stack([_bgr(rng.integers(0, 256, (H, W)), s) for s in range(b)])
    flow = rng.normal(0, 3, (b, H, W, 2)).astype(np.float32)
    box = np.array([[10, 20, 90, 100], [0, 0, W, H], [0, 0, 0, 0]], np.int32)
    got = tpred.warp_region(torch.from_numpy(frame), torch.from_numpy(flow),
                            torch.from_numpy(box)).numpy()
    ref = np.stack([np.asarray(jpred.warp_region(jnp.asarray(f), jnp.asarray(fl),
                                                 jnp.asarray(bx)))
                    for f, fl, bx in zip(frame, flow, box)])
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[2], frame[2])


def test_ssim_matches_jax():
    """Within 1e-5 of the JAX ``ssim`` (HIGHEST-precision convolution)."""
    rng = np.random.default_rng(4)
    im1 = rng.integers(0, 256, (3, 64, 80)).astype(np.float32)
    im2 = np.clip(im1 + rng.normal(0, 20, im1.shape), 0, 255).astype(np.float32)
    im2[2] = im1[2]
    got = tssim.ssim(torch.from_numpy(im1), torch.from_numpy(im2)).numpy()
    ref = np.array([float(jssim.ssim(jnp.asarray(a), jnp.asarray(b))) for a, b in zip(im1, im2)])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert got[2] == pytest.approx(1.0, abs=1e-6)


@pytest.fixture(scope="module")
def case():
    cfg = small_cfg()
    mem, prev, nxt = small_inputs(5, b=4)
    frame = np.stack([_bgr(n, i) for i, n in enumerate(nxt)])
    return cfg, config_from_dict(dataclasses.asdict(cfg)), mem, prev, nxt, frame


def _assert_pred_close(got, ref):
    """Against the jitted JAX warp, whose fused multiply-adds move a value
    that rounds near .5 by one level: ≤ 1 level, ≥ 99.99 % equal."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
    diff = np.abs(got.astype(np.int32) - ref)
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.9999


def _assert_flow_close(got, ref):
    assert np.abs(np.asarray(got) - np.asarray(ref)).max() <= 1e-2


def test_prediction_batch_fast_xla_matches_jax(case):
    cfg, tcfg, mem, prev, nxt, frame = case
    got = tpred.prediction_batch_fast(mem, prev, nxt, frame, tcfg, warp_radius=1,
                                      kernel_mode="xla", device="cpu")
    ref = jpred.prediction_batch_fast(jnp.asarray(mem), jnp.asarray(prev), jnp.asarray(nxt),
                                      jnp.asarray(frame), cfg, warp_radius=1, kernel_mode="xla")
    for key in ("box", "any_active"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]), key)
    _assert_flow_close(got["flow"].numpy(), ref["flow"])
    _assert_pred_close(got["pred"].numpy(), ref["pred"])
    # the same flow, warped op by op on both sides, gives the same frame
    same = tpred.warp_region(torch.from_numpy(frame), torch.from_numpy(np.array(ref["flow"])),
                             torch.where(got["any_active"][:, None], got["box"], 0))
    eager = np.stack([np.asarray(jpred.warp_region(jnp.asarray(f), jnp.asarray(fl),
                                                   jnp.asarray(bx)))
                      for f, fl, bx in zip(frame, np.asarray(ref["flow"]),
                                           np.where(np.asarray(ref["any_active"])[:, None],
                                                    np.asarray(ref["box"]), 0))])
    np.testing.assert_array_equal(same.numpy(), eager)
    ss = tpred.prediction_ssim(got["pred"], torch.from_numpy(frame))
    assert ss.shape == (4,) and torch.isfinite(ss).all()


def test_prediction_step_and_stages_match_jax(case):
    cfg, tcfg, mem, prev, nxt, frame = case
    i = 2
    got = tpred.prediction_step(mem[i], prev[i], nxt[i], frame[i], tcfg, device="cpu")
    ref = jpred.prediction_step(jnp.asarray(mem[i]), jnp.asarray(prev[i]),
                                jnp.asarray(nxt[i]), jnp.asarray(frame[i]), cfg)
    np.testing.assert_array_equal(got["box"].numpy(), np.asarray(ref["box"]))
    _assert_flow_close(got["flow"].numpy(), ref["flow"])
    _assert_pred_close(got["pred"].numpy(), ref["pred"])
    # 'cal' and 'vel' are roi_stages', held by tests/test_torch_seg_dual.py;
    # the prediction stages are fed the same flows on both sides
    js, ts = jpred.prediction_stages(cfg), tpred.prediction_stages(tcfg, device="cpu")
    jr, tr = js["cal"](jnp.asarray(mem[i])), ts["cal"](mem[i])
    tfw, _ = ts["vel"](prev[i], nxt[i], mem[i], tr)
    jfl = js["comb"](jnp.asarray(tfw.numpy()), jr["box"], jr["origin"])
    tfl = ts["comb"](tfw, tr["box"], tr["origin"])
    np.testing.assert_array_equal(tfl.numpy(), np.asarray(jfl))
    np.testing.assert_array_equal(tfl.numpy(), got["flow"].numpy())
    _assert_pred_close(ts["task"](frame[i], tfl, tr["box"], tr["active"]).numpy(),
                       js["task"](jnp.asarray(frame[i]), jfl, jr["box"], jr["active"]))
    tff = ts["vel_full"](prev[i], nxt[i])
    _assert_pred_close(ts["task_full"](frame[i], tff).numpy(),
                       js["task_full"](jnp.asarray(frame[i]), jnp.asarray(tff.numpy())))
    full = tpred.prediction_step_full(prev[i], nxt[i], frame[i], tcfg, device="cpu")
    np.testing.assert_array_equal(full["flow"].numpy(), tff.numpy())
    np.testing.assert_array_equal(full["pred"].numpy(),
                                  ts["task_full"](frame[i], tff).numpy())
