"""The port's labelling, statistics, NMS and tracking head against the JAX
package's.

Labelling: ``label_components_sweep`` at window scale (64×96 random masks
of three densities, 4- and 8-connected, with the JAX ``label_components``
as reference), a serpentine of 1-pixel corridors that needs one sweep a
turn (30 turns, so several convergence checks) and one of 300 turns that
reaches the JAX package's 256-sweep cap unconverged.  Stats, ``nms`` (ties
included) and ``box_iou`` exact.  Tracking: ``tracking_batch_fast`` with
``kernel_mode='xla'`` on both sides at B = 4 and warp radius 1 (the JAX
route's compile time grows with its (2r+2)² taps; the parity does not
depend on r), the head fed the JAX exact
flow, ``tracking_step``, ``tracking_step_full`` and the stages, on
``tests/test_torch_seg_dual.py``'s 120×160 grasp cut with a 64×96 window.

Measured here (15 tests): labels, stats, keep masks and IoUs equal;
boxes, valid and areas equal on every tracking path.  The gray images of
the head fed the same flows differ from the jitted JAX chain's at 28 of
the 34,304 in-box pixels, by one level (XLA fuses products into adds and
turns divisions by constants into reciprocal products; the angles, and so
the truncated hues, were equal here, though torch's atan2 and XLA's are
one ulp apart for 10.9 % of random flows); no box moved.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsof_tpu.ops import components as jcc
from nsof_tpu.pipelines import tracking as jtrk
from nsof_tpu_torch.config import config_from_dict
from nsof_tpu_torch.ops import components as tcc
from nsof_tpu_torch.pipelines import tracking as ttrk
from tests.test_torch_seg_dual import small_cfg, small_inputs

TRACK_KEYS = ("boxes", "valid", "areas")


def _jax_labels(masks, connectivity):
    return np.stack([np.asarray(jcc.label_components(jnp.asarray(m), connectivity))
                     for m in masks])


def _serpentine(turns: int, width: int = 6) -> np.ndarray:
    """Corridors on the even rows, joined by a connector at alternating
    ends: one path of ``turns`` turns."""
    m = np.zeros((2 * turns + 1, width), bool)
    m[::2] = True
    m[1::4, -1] = True
    m[3::4, 0] = True
    return m


@pytest.mark.parametrize("connectivity", [4, 8])
def test_sweep_labels_match_jax_at_window_scale(connectivity):
    rng = np.random.default_rng(connectivity)
    masks = np.stack([rng.random((64, 96)) < p for p in (0.3, 0.55, 0.8)])
    masks[2, :, 40] = False  # a wall through the dense mask
    got = tcc.label_components_sweep(torch.from_numpy(masks), connectivity)
    np.testing.assert_array_equal(got.numpy(), _jax_labels(masks, connectivity))
    grid = tcc.label_components(torch.from_numpy(masks[:, :8, :10]), connectivity)
    np.testing.assert_array_equal(
        tcc.label_components_sweep(torch.from_numpy(masks[:, :8, :10]), connectivity),
        grid)


@pytest.mark.parametrize("turns", [30, 300])
def test_sweep_labels_serpentine(turns):
    """30 turns converge after several checks; 300 turns reach the
    256-sweep cap, where the JAX labels are not yet final either."""
    m = _serpentine(turns)
    got = tcc.label_components_sweep(torch.from_numpy(m[None]), 4)[0].numpy()
    ref = np.asarray(jcc.label_components(jnp.asarray(m), 4))
    np.testing.assert_array_equal(got, ref)
    final = (got[m] == 0).all()
    assert final == (turns == 30)


@pytest.mark.parametrize("form", ["component_stats", "component_stats_scatter"])
@pytest.mark.parametrize("k_max", [4, 32])
def test_component_stats_match_jax(k_max, form):
    rng = np.random.default_rng(k_max)
    masks = np.stack([rng.random((40, 52)) < 0.45 for _ in range(3)])
    labels = _jax_labels(masks, 8)
    got = getattr(tcc, form)(torch.from_numpy(labels), k_max)
    ref = jax.vmap(lambda lab: jcc.component_stats(lab, k_max))(jnp.asarray(labels))
    for key in ("boxes", "areas", "valid", "count"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]), key)


@pytest.mark.parametrize("plus_one", [True, False])
def test_nms_and_box_iou_match_jax(plus_one):
    rng = np.random.default_rng(7)
    b, n = 6, 32
    xy = rng.integers(0, 60, (b, n, 2))
    wh = rng.integers(1, 40, (b, n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = rng.integers(0, 6, (b, n)).astype(np.float32)  # many ties
    valid = rng.random((b, n)) < 0.8
    valid[0] = False
    got = tcc.nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                  torch.from_numpy(valid), 0.2, plus_one)
    ref = jax.vmap(lambda bx, s, v: jcc.nms(bx, s, v, 0.2, plus_one))(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    iou = tcc.box_iou(torch.from_numpy(boxes[:, :, None]), torch.from_numpy(boxes[:, None]))
    ref = jax.vmap(jax.vmap(jax.vmap(jcc.box_iou, (None, 0)), (0, None)))(
        jnp.asarray(boxes), jnp.asarray(boxes))
    np.testing.assert_array_equal(iou.numpy(), np.asarray(ref))


@pytest.fixture(scope="module")
def cfgs():
    cfg = small_cfg()
    return cfg, config_from_dict(dataclasses.asdict(cfg))


def _assert_tracks_equal(got, ref, keys=TRACK_KEYS):
    for key in keys:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(ref[key]), key)


def test_tracking_batch_fast_xla_matches_jax(cfgs):
    cfg, tcfg = cfgs
    mem, prev, nxt = (a[:4] for a in small_inputs(1))
    got = ttrk.tracking_batch_fast(mem, prev, nxt, tcfg, warp_radius=1, kernel_mode="xla",
                                   device="cpu")
    ref = jtrk.tracking_batch_fast(jnp.asarray(mem), jnp.asarray(prev), jnp.asarray(nxt),
                                   cfg, warp_radius=1, kernel_mode="xla")
    _assert_tracks_equal({k: v.numpy() for k, v in got.items()}, ref,
                         TRACK_KEYS + ("box", "any_active"))
    assert got["valid"][1:].any(dim=1).all() and not got["valid"][0].any()


@pytest.fixture(scope="module")
def stages(cfgs):
    """The JAX and the port's tracking stages, each JAX stage compiled once."""
    cfg, tcfg = cfgs
    return jtrk.tracking_stages(cfg), ttrk.tracking_stages(tcfg, device="cpu")


def test_head_on_jax_flow_gives_jax_boxes(cfgs, stages):
    """The batched head fed the JAX 'vel' stage's flows gives the JAX
    'task' stage's boxes; the gray images differ at ≤ 0.1 % of pixels."""
    cfg, tcfg = cfgs
    js, _ = stages
    mem, prev, nxt = small_inputs(2)
    rois = [js["cal"](jnp.asarray(m)) for m in mem]
    vels = [js["vel"](jnp.asarray(p), jnp.asarray(n), jnp.asarray(m), r)
            for m, p, n, r in zip(mem, prev, nxt, rois)]
    flow = torch.from_numpy(np.stack([np.asarray(v[0]) for v in vels]))
    inbox = torch.from_numpy(np.stack([np.asarray(v[1]) for v in vels]))
    oys = torch.tensor([int(r["origin"][0]) for r in rois], dtype=torch.int32)
    oxs = torch.tensor([int(r["origin"][1]) for r in rois], dtype=torch.int32)
    got = ttrk.tracking_head_window(flow, inbox, (oys, oxs), tcfg)
    for i, (v, r) in enumerate(zip(vels, rois)):
        ref = js["task"](v[0], v[1], r["origin"], True)
        _assert_tracks_equal({k: t[i].numpy() for k, t in got.items()}, ref)
    assert got["valid"][1:].any(dim=1).all()
    gray = ttrk.flow_gray_window(flow, inbox).numpy()
    jgray = np.asarray(jax.jit(jax.vmap(jtrk.flow_gray_window))(
        jnp.asarray(flow.numpy()), jnp.asarray(inbox.numpy())))
    assert (gray != jgray).sum() <= 0.001 * gray.size


def test_tracking_step_matches_jax(cfgs):
    cfg, tcfg = cfgs
    mem, prev, nxt = small_inputs(3)
    for i in (3, 6):
        got = ttrk.tracking_step(mem[i], prev[i], nxt[i], tcfg, device="cpu")
        ref = jtrk.tracking_step(jnp.asarray(mem[i]), jnp.asarray(prev[i]),
                                 jnp.asarray(nxt[i]), cfg)
        _assert_tracks_equal({k: v.numpy() for k, v in got.items()}, ref,
                             TRACK_KEYS + ("box", "any_active"))
        np.testing.assert_array_max_ulp(got["region_pct"].numpy(),
                                        np.asarray(ref["region_pct"]), maxulp=1)


def test_tracking_stages_match_jax(cfgs, stages):
    """Each stage against the JAX stage, 'task' fed the JAX 'vel' outputs
    and 'task_full' the same full-frame flow ('vel_full' is held by
    tests/test_torch_seg_dual.py); ``tracking_step_full`` is 'vel_full'
    then 'task_full'."""
    _, tcfg = cfgs
    js, ts = stages
    mem, prev, nxt = small_inputs(4)
    i = 5
    jr = js["cal"](jnp.asarray(mem[i]))
    tr = ts["cal"](mem[i])
    for key in ("box", "active"):
        np.testing.assert_array_equal(tr[key].numpy(), np.asarray(jr[key]), key)
    jfw, jib = js["vel"](jnp.asarray(prev[i]), jnp.asarray(nxt[i]), jnp.asarray(mem[i]), jr)
    tfw, tib = ts["vel"](prev[i], nxt[i], mem[i], tr)
    assert np.abs(tfw.numpy() - np.asarray(jfw)).max() <= 1e-2
    np.testing.assert_array_equal(tib.numpy(), np.asarray(jib))
    got = ts["task"](torch.from_numpy(np.array(jfw)), torch.from_numpy(np.array(jib)),
                     tr["origin"], tr["active"])
    _assert_tracks_equal({k: v.numpy() for k, v in got.items()},
                         js["task"](jfw, jib, jr["origin"], jr["active"]))
    tff = ts["vel_full"](prev[i], nxt[i])
    got = ts["task_full"](tff)
    _assert_tracks_equal({k: v.numpy() for k, v in got.items()},
                         js["task_full"](jnp.asarray(tff.numpy())))
    full = ttrk.tracking_step_full(prev[i], nxt[i], tcfg, device="cpu")
    _assert_tracks_equal(full, ts["task_full"](tff))
    assert "comb" not in ts


def test_metrics_match_jax():
    rng = np.random.default_rng(9)
    mask = np.zeros((50, 60), np.uint8)
    mask[5:20, 3:30] = 255
    mask[30:48, 40:44] = 255
    mask[rng.random((50, 60)) < 0.02] = 255
    box, found = ttrk.max_bbox_from_mask(torch.from_numpy(mask))
    jbox, jfound = jtrk.max_bbox_from_mask(jnp.asarray(mask))
    np.testing.assert_array_equal(box.numpy(), np.asarray(jbox))
    assert bool(found) == bool(jfound)
    boxes = np.array([[0, 0, 30, 20], [4, 6, 29, 19], [50, 50, 60, 60]], np.float32)
    for valid in ([True, True, False], [False] * 3):
        got = ttrk.mean_iou_vs_gt(torch.from_numpy(boxes), torch.tensor(valid), box)
        ref = jtrk.mean_iou_vs_gt(jnp.asarray(boxes), jnp.asarray(valid), jbox)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
