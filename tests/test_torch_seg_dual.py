"""The port's exact segmentation path and dual-path stages against the JAX
package's.

``seg_batch``, ``seg_step``, ``seg_step_full`` and each stage of
``seg_stages`` (``device='cpu'``) against the jitted JAX functions on
120×160 frames, memsize 20 (a 6×8 state grid), a 64×96 window, the grasp
preset, B = 8: a random texture moved by (2, −1) px in the style of
bench.py and an active 2×2 block of the state map at a random place, one
sample with no active cell and one saturated, made with numpy from a seed.

Measured here (7 tests): box, any_active and origins exact; region_pct
exact against the JAX formula run op by op (the jitted one is within one
float32 ulp); windowed flow max 2.2e-6 px, mean 3.9e-8 px; full-frame flow
max 1.9e-6 px, mean 2.0e-7 px; masks 100 % equal; the head, the scatter
and the stages fed the JAX stage outputs give the JAX outputs bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsof_tpu.config import DATASETS
from nsof_tpu.ops import roi as jroi
from nsof_tpu.pipelines import segmentation as jseg
from nsof_tpu_torch.config import config_from_dict
from nsof_tpu_torch.pipelines import segmentation as tseg

H, W, MEMSIZE, B = 120, 160, 20, 8
WIN = (64, 96)


def small_cfg():
    """The grasp preset at 120×160 with a 64×96 window."""
    cfg = dataclasses.replace(DATASETS["grasp"], name="test120", image_h=H, image_w=W,
                              window_h=WIN[0], window_w=WIN[1], warp_radius=3)
    return dataclasses.replace(cfg, roi=dataclasses.replace(cfg.roi, memsize=MEMSIZE))


def small_inputs(seed=0, b=B):
    """bench-style frames and state maps; sample 0 has no active cell,
    sample 1 is saturated."""
    rng = np.random.default_rng(seed)
    base = rng.random((H + 64, W + 64)).astype(np.float32) * 255
    prev = np.stack([base[16 + v % 5 : 16 + v % 5 + H, 16 : 16 + W]
                     for v in range(b)]).astype(np.uint8)
    nxt = np.stack([base[18 + v % 5 : 18 + v % 5 + H, 15 : 15 + W]
                    for v in range(b)]).astype(np.uint8)
    mem = np.zeros((b, H // MEMSIZE, W // MEMSIZE), np.uint8)
    for i in range(b):
        y, x = rng.integers(0, 5), rng.integers(0, 7)
        mem[i, y : y + 2, x : x + 2] = 255
    mem[0] = 0
    mem[1] = 255
    return mem, prev, nxt


def assert_flow_close(got, ref):
    assert got.shape == ref.shape
    err = np.abs(np.asarray(got) - np.asarray(ref))
    assert err.max() <= 1e-2, err.max()
    assert err.mean() <= 5e-4, err.mean()


@pytest.fixture(scope="module")
def runs():
    cfg = small_cfg()
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    mem, prev, nxt = small_inputs()
    got = {k: v.numpy() for k, v in tseg.seg_batch(mem, prev, nxt, tcfg,
                                                   device="cpu").items()}
    ref = jseg.seg_batch(jnp.asarray(mem), jnp.asarray(prev), jnp.asarray(nxt), cfg)
    return cfg, tcfg, (mem, prev, nxt), got, {k: np.array(v) for k, v in ref.items()}


def test_seg_batch_roi_exact(runs):
    *_, got, ref = runs
    for key in ("box", "any_active"):
        np.testing.assert_array_equal(got[key], ref[key], key)
    assert not got["any_active"][0] and got["any_active"][1:].all()
    eager = jax.vmap(lambda bx: jroi.region_percentage(bx, H, W))(jnp.asarray(ref["box"]))
    np.testing.assert_array_equal(got["region_pct"], np.asarray(eager))
    np.testing.assert_array_max_ulp(got["region_pct"], ref["region_pct"], maxulp=1)


def test_seg_batch_flow_and_mask(runs):
    *_, got, ref = runs
    assert_flow_close(got["flow"], ref["flow"])
    assert got["mask"].dtype == np.uint8 and got["mask"].shape == (B, H, W)
    assert (got["mask"] == ref["mask"]).mean() >= 0.995
    assert (ref["mask"] > 0).any()


def test_seg_head_on_jax_flow_bit_exact(runs):
    """The exact head and scatter fed the JAX flow give the JAX mask."""
    _, tcfg, (mem, _, _), _, ref = runs
    roi = tseg.gate(torch.from_numpy(mem), tcfg)
    oys, oxs = roi["origin"]
    flow_win = tseg.roi_ops.crop_windows(torch.from_numpy(ref["flow"]), oys, oxs, *WIN)
    inbox = tseg.roi_ops.window_box_mask(roi["box"], oys, oxs, *WIN)
    inbox &= roi["active"][:, None, None]
    mask_win = tseg.seg_head_window(flow_win, inbox, tcfg)
    mask = tseg.roi_ops.scatter_window(torch.zeros((B, H, W), dtype=torch.uint8),
                                       mask_win, roi["box"], oys, oxs)
    np.testing.assert_array_equal(mask.numpy(), ref["mask"])


def test_seg_step_is_seg_batch_of_one(runs):
    _, tcfg, (mem, prev, nxt), got, _ = runs
    for i in (1, 5):
        one = tseg.seg_step(mem[i], prev[i], nxt[i], tcfg, device="cpu")
        for key, val in one.items():
            np.testing.assert_array_equal(val.numpy(), got[key][i], key)


def test_seg_step_full_matches_jax(runs):
    cfg, tcfg, (_, prev, nxt), _, _ = runs
    got = tseg.seg_step_full(prev[2], nxt[2], tcfg, device="cpu")
    ref = jseg.seg_step_full(jnp.asarray(prev[2]), jnp.asarray(nxt[2]), cfg)
    assert_flow_close(got["flow"].numpy(), ref["flow"])
    assert (got["mask"].numpy() == np.asarray(ref["mask"])).mean() >= 0.995


def test_seg_stages_match_jax(runs):
    """Each stage against the JAX stage; 'task', 'comb' and 'task_full'
    fed the JAX stage outputs, bit for bit."""
    cfg, tcfg, (mem, prev, nxt), _, _ = runs
    js, ts = jseg.seg_stages(cfg), tseg.seg_stages(tcfg, device="cpu")
    i = 4
    jroi_ = js["cal"](jnp.asarray(mem[i]))
    troi_ = ts["cal"](mem[i])
    for key in ("box", "active"):
        np.testing.assert_array_equal(troi_[key].numpy(), np.asarray(jroi_[key]), key)
    for t, j in zip(troi_["origin"], jroi_["origin"]):
        assert int(t) == int(j)
    np.testing.assert_array_max_ulp(troi_["region_pct"].numpy(),
                                    np.asarray(jroi_["region_pct"]), maxulp=1)
    jfw, jib = js["vel"](jnp.asarray(prev[i]), jnp.asarray(nxt[i]), jnp.asarray(mem[i]), jroi_)
    tfw, tib = ts["vel"](prev[i], nxt[i], mem[i], troi_)
    assert_flow_close(tfw.numpy(), jfw)
    np.testing.assert_array_equal(tib.numpy(), np.asarray(jib))
    jmw = np.array(js["task"](jfw, jib))
    tmw = ts["task"](torch.from_numpy(np.array(jfw)), torch.from_numpy(np.array(jib)))
    np.testing.assert_array_equal(tmw.numpy(), jmw)
    assert (tmw > 0).any()
    jm = np.asarray(js["comb"](jnp.asarray(jmw), jroi_["box"], jroi_["origin"]))
    tm = ts["comb"](torch.from_numpy(jmw), troi_["box"], troi_["origin"])
    np.testing.assert_array_equal(tm.numpy(), jm)
    jff = js["vel_full"](jnp.asarray(prev[i]), jnp.asarray(nxt[i]))
    assert_flow_close(ts["vel_full"](prev[i], nxt[i]).numpy(), jff)
    np.testing.assert_array_equal(ts["task_full"](torch.from_numpy(np.array(jff))).numpy(),
                                  np.asarray(js["task_full"](jff)))


def test_roi_stages_refuse_separate_regions():
    """FLAG=1 (``cfg.roi.mode == 1``) is served now: 'cal' gives the
    separate regions' union box and summed percentage, as the JAX stages
    do (the full mode-1 parity is in tests/test_torch_separate.py)."""
    cfg = dataclasses.replace(small_cfg(), roi=dataclasses.replace(small_cfg().roi, mode=1))
    mem = small_inputs()[0][2]
    ref = jseg.roi_stages(cfg)["cal"](mem)
    got = tseg.roi_stages(config_from_dict(dataclasses.asdict(cfg)), device="cpu")["cal"](mem)
    for key in ("box", "active", "region_pct"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]), err_msg=key)
