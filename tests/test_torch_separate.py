"""The port's FLAG=1 separate-regions pipelines against the JAX package's.

``grasp_sep`` cut to 120×160 frames: memsize 20 (a 6×8 state grid), k_max
8, 48×64 per-region windows, a 64×96 head window, the grasp Farnebäck
preset; and, for ``roi_stages`` mode 1, the uav preset (poly_n 10, the
FLAG=1 datasets' Farnebäck) on the same cut.  Three frame pairs of a random
texture moved by (2, −1) px in the style of bench.py, made with numpy from
a seed; their state maps hold three components whose EXTEND-padded boxes
overlap (the later slot overwrites the earlier one's flow there), one
component, and none.

Every entry point (``device='cpu'``) against the jitted JAX one: boxes,
valid flags, union box, ``any_active`` and ``region_pct`` equal; flows
within PERF.md §2's limits (1e-2 px max, 5e-4 px mean); masks ≥ 99.5 %
equal; tracking boxes, valid flags and areas equal; predicted frames
within one level at ≥ 99.99 % equal (the jitted JAX warp fuses products
into adds).  Measured on the CPU: flows within 1.9e-6 px (mean ≤ 6.6e-8 px),
masks, tracking boxes and predicted frames equal.  ``seg_stages``,
``tracking_stages`` and ``prediction_stages`` run the FLAG=1 preset end to
end.
"""

import dataclasses

import numpy as np
import pytest
import torch

from nsof_tpu.config import DATASETS
from nsof_tpu.pipelines import segmentation as jseg
from nsof_tpu.pipelines import separate as jsep
from nsof_tpu_torch.config import config_from_dict
from nsof_tpu_torch.pipelines import prediction as tpred
from nsof_tpu_torch.pipelines import segmentation as tseg
from nsof_tpu_torch.pipelines import separate as tsep
from nsof_tpu_torch.pipelines import tracking as ttrk

H, W, MEMSIZE = 120, 160, 20


def sep_cfg(fb_preset="grasp"):
    cfg = dataclasses.replace(DATASETS["grasp_sep"], name="sep120", image_h=H, image_w=W,
                              window_h=64, window_w=96, sep_window_h=48, sep_window_w=64,
                              fb=DATASETS[fb_preset].fb)
    return dataclasses.replace(cfg, roi=dataclasses.replace(cfg.roi, memsize=MEMSIZE))


def tcfg_of(cfg):
    return config_from_dict(dataclasses.asdict(cfg))


def pairs():
    """Three (mem, prev, next, next BGR frame) samples."""
    rng = np.random.default_rng(7)
    base = rng.random((H + 64, W + 64)).astype(np.float32) * 255
    out = []
    for v, cells in enumerate([((0, 0), (1, 2), (4, 5)), ((2, 3),), ()]):
        prev = base[16 + v : 16 + v + H, 16 : 16 + W].astype(np.uint8)
        nxt = base[18 + v : 18 + v + H, 15 : 15 + W].astype(np.uint8)
        mem = np.zeros((H // MEMSIZE, W // MEMSIZE), np.uint8)
        for y, x in cells:
            mem[y : y + 1, x : x + 2] = 255
        frame = np.stack([nxt, 255 - nxt, (3 * nxt.astype(np.int32) + 17) % 256],
                         -1).astype(np.uint8)
        out.append((mem, prev, nxt, frame))
    return out


PAIRS = pairs()


def assert_flow_close(got, ref):
    err = np.abs(got.numpy() - np.asarray(ref))
    assert err.max() <= 1e-2 and err.mean() <= 5e-4, (err.max(), err.mean())


def assert_equal(got, ref, keys):
    for key in keys:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]), err_msg=key)


def test_union_box_matches_jax():
    rng = np.random.default_rng(0)
    boxes = rng.integers(-30, 200, (8, 4)).astype(np.int32)
    for valid in (rng.random(8) < 0.5, np.zeros(8, bool)):
        ref = np.asarray(jsep.union_box(boxes, valid, 20, H, W))
        got = tsep.union_box(torch.from_numpy(boxes), torch.from_numpy(valid), 20, H, W)
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("i", range(len(PAIRS)))
def test_separate_flow_field_matches_jax(i):
    cfg = sep_cfg()
    mem, prev, nxt, _ = PAIRS[i]
    ref = jax_jit_field(cfg)(mem, prev, nxt)
    got = tsep.separate_flow_field(mem, prev, nxt, tcfg_of(cfg), device="cpu")
    assert_equal(got, ref, ("boxes", "valid", "region_pcts", "union", "any_active"))
    assert_flow_close(got["flow"], ref["flow"])
    if i == 0:
        assert int(got["valid"].sum()) == 3


_FIELDS = {}


def jax_jit_field(cfg):
    import jax

    if cfg not in _FIELDS:
        _FIELDS[cfg] = jax.jit(lambda m, p, n: jsep.separate_flow_field(m, p, n, cfg))
    return _FIELDS[cfg]


@pytest.mark.parametrize("merge", [True, False])
def test_seg_step_separate_matches_jax(merge):
    cfg = sep_cfg()
    for mem, prev, nxt, _ in PAIRS:
        ref = jsep.seg_step_separate(mem, prev, nxt, cfg, merge_head=merge)
        got = tsep.seg_step_separate(mem, prev, nxt, tcfg_of(cfg), merge_head=merge,
                                     device="cpu")
        assert set(got) == set(ref)
        assert_equal(got, ref, ("boxes", "valid", "box", "any_active", "region_pct"))
        assert_flow_close(got["flow"], ref["flow"])
        assert (got["mask"].numpy() == np.asarray(ref["mask"])).mean() >= 0.995
    assert got["mask"].sum() == 0


def test_tracking_step_separate_matches_jax():
    cfg = sep_cfg()
    for mem, prev, nxt, _ in PAIRS:
        ref = jsep.tracking_step_separate(mem, prev, nxt, cfg)
        got = tsep.tracking_step_separate(mem, prev, nxt, tcfg_of(cfg), device="cpu")
        assert_equal(got, ref, ("valid", "areas", "box", "any_active", "region_pct"))
        valid = got["valid"].numpy()
        np.testing.assert_array_equal(got["boxes"].numpy()[valid], np.asarray(ref["boxes"])[valid])


def test_prediction_step_separate_matches_jax():
    cfg = sep_cfg()
    for mem, prev, nxt, frame in PAIRS:
        ref = jsep.prediction_step_separate(mem, prev, nxt, frame, cfg)
        got = tsep.prediction_step_separate(mem, prev, nxt, frame, tcfg_of(cfg), device="cpu")
        assert_equal(got, ref, ("box", "any_active", "region_pct"))
        assert_flow_close(got["flow"], ref["flow"])
        d = np.abs(got["pred"].numpy().astype(int) - np.asarray(ref["pred"]).astype(int))
        assert d.max() <= 1 and (d == 0).mean() >= 0.9999


@pytest.mark.parametrize("preset", ["grasp", "uav"])
def test_roi_stages_mode_1_match_jax(preset):
    cfg = sep_cfg(preset)
    js = jseg.roi_stages(cfg)
    ts = tseg.roi_stages(tcfg_of(cfg), device="cpu")
    for mem, prev, nxt, _ in PAIRS[:2]:
        jroi = js["cal"](mem)
        troi = ts["cal"](mem)
        for key in ("box", "active", "region_pct"):
            np.testing.assert_array_equal(troi[key].numpy(), np.asarray(jroi[key]), err_msg=key)
        for a, b in zip(troi["origin"], jroi["origin"]):
            assert int(a) == int(b)
        jf, jin = js["vel"](prev, nxt, mem, jroi)
        tf, tin = ts["vel"](prev, nxt, mem, troi)
        np.testing.assert_array_equal(tin.numpy(), np.asarray(jin))
        assert_flow_close(tf, jf)


def test_flag1_stages_run_end_to_end():
    """The segmentation, tracking and prediction stages of a FLAG=1 preset
    on one pair: the ROI mask sits inside the union box and the prediction
    changes nothing outside it."""
    cfg = tcfg_of(sep_cfg())
    mem, prev, nxt, frame = PAIRS[0]
    st = tseg.seg_stages(cfg, device="cpu")
    roi = st["cal"](mem)
    flow_win, inbox = st["vel"](prev, nxt, mem, roi)
    mask = st["comb"](st["task"](flow_win, inbox), roi["box"], roi["origin"])
    x0, y0, x1, y1 = roi["box"].tolist()
    assert mask.sum() == mask[y0:y1, x0:x1].sum() > 0
    tr = ttrk.tracking_stages(cfg, device="cpu")
    out = tr["task"](flow_win, inbox, roi["origin"], roi["active"])
    assert out["valid"].shape == (cfg.head.max_boxes,)
    pr = tpred.prediction_stages(cfg, device="cpu")
    flow = pr["comb"](flow_win, roi["box"], roi["origin"])
    pred = pr["task"](torch.from_numpy(frame), flow, roi["box"], roi["active"])
    outside = torch.ones((H, W), dtype=torch.bool)
    outside[y0:y1, x0:x1] = False
    assert torch.equal(pred[outside], torch.from_numpy(frame)[outside])
