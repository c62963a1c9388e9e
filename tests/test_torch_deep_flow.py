"""The port's ROI-gated deep pipelines (``nsof_tpu_torch/pipelines/
deep_flow.py``), its deep serving engine and its CLI's ``deep`` against the
JAX package's.

On grasp cut to 96×144 1/3-scale RGB frames (memsize 48, so 16 on the deep
grid of 6×9 cells), a 64×96 window, three samples: a block active in the
middle, one at the bottom-right edge (the window's origin clamped), one
whose box is under 64 px (inactive).  The backend is RAFT-small, iters 3,
under seeded random weights (``tests/torch_deep_weights.py``) carried into
the port by ``params_from_jax`` (``tests/test_torch_flowformer.py`` runs
the batched step on FlowFormer).  Every step against the JAX step on the same inputs: boxes,
activity and region percentages equal, flows within 1e-3 px, masks ≥ 99.5 %
equal, tracking boxes equal, predicted frames ≥ 99.5 % equal and within
one level.  Also ``resize_third`` (exact where 3 divides the side, 1e-4
otherwise, against ``jax.image.resize``); the window ≤ frame precondition, which raises on the CPU too;
``BatchingEngine.for_deep_backend`` (its state maps on the MEMSIZE/3 grid,
each result equal to the direct ``deep_roi_flow_batch`` of the padded
batch it went in; its warm-up runs the backend on every bucket whole).
``tests/test_torch_cli.py`` runs the CLI's ``deep``.
With a spy backend: the batch's backend sees only the active rows (a
mixed batch; all rows, with no gather, when all are active; no call when
none is), each row's outputs equal its own step's, and the rows run and
skipped are counted; an inactive B = 1 step of each task makes no
backend call.

Measured here: flows within 4.2e-5 px (flows up to 26 px), masks, region
percentages, tracking boxes and areas equal, predicted frames 99.94–99.98 %
equal and never more than one level apart (the warp's bilinear weights
move with the flow's last bits), ``resize_third`` equal to JAX's on both
sizes.
"""

import dataclasses
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from nsof_tpu.config import DATASETS as JDATASETS
from nsof_tpu.models.raft import RAFT as JRAFT
from nsof_tpu.models.raft import RaftConfig as JRaftConfig
from nsof_tpu.pipelines import deep_flow as jdf
from nsof_tpu_torch import _build
from nsof_tpu_torch.config import config_from_dict
from nsof_tpu_torch.models.convert import params_from_jax
from nsof_tpu_torch.models.raft import RAFT, RaftConfig
from nsof_tpu_torch.pipelines import deep_flow as tdf
from nsof_tpu_torch.serve.engine import BatchingEngine
from tests.torch_deep_weights import raft_params
from torch_single_thread import one_torch_thread  # noqa: F401  (autouse)

FLOW_TOL = 1e-3  # px
MASK_EQUAL = 0.995
ITERS = 3
H, W, WIN = 96, 144, (64, 96)


def _jcfg():
    cfg = dataclasses.replace(JDATASETS["grasp"], image_h=H, image_w=W, window_h=WIN[0],
                              window_w=WIN[1])
    return dataclasses.replace(cfg, roi=dataclasses.replace(cfg.roi, memsize=48))


JCFG = _jcfg()
TCFG = config_from_dict(dataclasses.asdict(JCFG))


def _inputs():
    """Three samples: state maps [3, 6, 9], frames [3, H, W, 3], the next
    frames moved by (1, 2) px, and the frames after those."""
    rng = np.random.default_rng(3)
    base = (rng.random((3, H + 8, W + 8, 3)) * 255).astype(np.uint8)
    prev = np.ascontiguousarray(base[:, 4:4 + H, 4:4 + W])
    nxt = np.ascontiguousarray(base[:, 3:3 + H, 2:2 + W])
    fut = np.ascontiguousarray(base[:, 2:2 + H, 0:W])
    mem = np.zeros((3, 6, 9), np.uint8)
    mem[0, 2:4, 3:5] = 255  # box 72×72 inside the frame
    mem[1, 3:6, 6:9] = 255  # box at the bottom-right corner
    mem[2, 0, 0] = 255  # box 36×36: under MIN_REGION_PX
    return mem, prev, nxt, fut


@pytest.fixture(scope="module")
def backends():
    jcfg = JRaftConfig(small=True, iters=ITERS)
    params = raft_params(jcfg, seed=0)
    model = RAFT(RaftConfig(small=True, iters=ITERS))
    model.load_state_dict(params_from_jax(params, model.cfg))
    return (jdf.DeepBackend.from_raft(JRAFT(jcfg), params, iters=ITERS),
            tdf.DeepBackend.from_raft(model, iters=ITERS, device="cpu"))


def _close(got: dict, want: dict, keys) -> None:
    for k in keys:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape, k
        if k == "flow":
            np.testing.assert_allclose(g, w, rtol=0, atol=FLOW_TOL)
        elif k in ("mask", "pred"):
            assert (g == w).mean() >= MASK_EQUAL, k
            assert np.abs(g.astype(int) - w.astype(int)).max() <= (1 if k == "pred" else 255)
        elif k == "region_pct":
            np.testing.assert_allclose(g, w, rtol=1e-6)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


ROI_STEPS = {
    "flow": (lambda m, p, n, f, cfg, be, mod: mod.deep_roi_flow_step(m, p, n, cfg, be),
             ("flow", "mask", "box", "any_active", "region_pct")),
    "tracking": (lambda m, p, n, f, cfg, be, mod: mod.deep_roi_tracking_step(m, p, n, cfg, be),
                 ("boxes", "valid", "areas", "box", "any_active", "region_pct")),
    "prediction": (lambda m, p, n, f, cfg, be, mod: mod.deep_roi_prediction_step(
        m, p, n, f, cfg, be), ("pred", "flow", "box", "any_active", "region_pct")),
}
BATCH_KEYS = ("flow", "mask", "box", "any_active", "region_pct")
FULL_STEPS = {
    "flow": (lambda p, n, f, cfg, be, mod: mod.deep_full_flow_step(p, n, cfg, be),
             ("flow", "mask")),
    "tracking": (lambda p, n, f, cfg, be, mod: mod.deep_full_tracking_step(p, n, cfg, be),
                 ("boxes", "valid", "areas")),
    "prediction": (lambda p, n, f, cfg, be, mod: mod.deep_full_prediction_step(p, n, f, cfg, be),
                   ("pred", "flow")),
}


@pytest.mark.parametrize("task", sorted(ROI_STEPS))
def test_deep_roi_steps_match_jax(task, backends):
    jbe, tbe = backends
    step, keys = ROI_STEPS[task]
    jstep = jax.jit(lambda m, p, n, f: step(m, p, n, f, JCFG, jbe, jdf))
    mem, prev, nxt, fut = _inputs()
    for i in range(3):
        want = jstep(mem[i], prev[i], nxt[i], fut[i])
        got = step(mem[i], prev[i], nxt[i], fut[i], TCFG, tbe, tdf)
        _close(got, want, keys)
        assert bool(got["any_active"]) == (i < 2)


@pytest.mark.parametrize("task", sorted(FULL_STEPS))
def test_deep_full_steps_match_jax(task, backends):
    jbe, tbe = backends
    step, keys = FULL_STEPS[task]
    _, prev, nxt, fut = _inputs()
    want = jax.jit(lambda p, n, f: step(p, n, f, JCFG, jbe, jdf))(prev[0], nxt[0], fut[0])
    _close(step(prev[0], nxt[0], fut[0], TCFG, tbe, tdf), want, keys)


def test_deep_roi_flow_batch_matches_jax(backends):
    jbe, tbe = backends
    mem, prev, nxt, _ = _inputs()
    want = jax.jit(lambda m, p, n: jdf.deep_roi_flow_batch(m, p, n, JCFG, jbe))(mem, prev, nxt)
    got = tdf.deep_roi_flow_batch(mem, prev, nxt, TCFG, tbe)
    _close(got, want, BATCH_KEYS)
    for i in range(3):  # the batch against the single steps
        one = tdf.deep_roi_flow_step(mem[i], prev[i], nxt[i], TCFG, tbe)
        torch.testing.assert_close(got["flow"][i], one["flow"], rtol=0, atol=1e-4)


def _spy(backend, seen: list, refuse: bool = False):
    """``backend`` with an ``apply`` that records the windows it is given,
    or raises when ``refuse``."""
    def apply(img1, img2):
        if refuse:
            raise AssertionError("the backend ran on a call with no active row")
        seen.append(img1.clone())
        return backend.apply(img1, img2)
    return dataclasses.replace(backend, apply=apply)


def _op_names(prof, span_name: str) -> list:
    return [c.name for e in prof.events() if e.name == span_name for c in e.cpu_children]


# samples of _inputs() a batch is made of: rows 0 and 1 active, row 2 not
ROW_MIXES = {"mixed": [0, 1, 2], "all_active": [1, 0, 1], "none_active": [2, 2, 2]}


@pytest.mark.parametrize("mix", sorted(ROW_MIXES))
def test_deep_roi_flow_batch_runs_the_backend_on_the_active_rows_only(mix, backends):
    """The backend sees exactly the active rows' windows (all B of them,
    with no gather and no copy back, when every row is active; no call when
    none is); every output equals the per-row ``deep_roi_flow_step``'s; the
    ``nsof.flow`` count and ``_build.COUNTS`` hold the rows run and
    skipped."""
    from torch.profiler import ProfilerActivity, profile

    from nsof_tpu_torch.ops import roi as roi_ops
    from nsof_tpu_torch.utils import timing

    _, tbe = backends
    rows = ROW_MIXES[mix]
    mem, prev, nxt, _ = (torch.from_numpy(x[rows]) for x in _inputs())
    active = [r != 2 for r in rows]
    n, b = sum(active), len(rows)
    seen = []
    spy = _spy(tbe, seen, refuse=n == 0)
    _build.reset_launches()
    timing.reset_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = tdf.deep_roi_flow_batch(mem, prev, nxt, TCFG, spy)
    flow_counts = timing.counted("nsof.flow")
    timing.reset_counts()
    assert got["any_active"].tolist() == active
    assert (_build.COUNTS["deep_flow_rows"], _build.COUNTS["deep_flow_rows_skipped"]) == (n, b - n)
    assert flow_counts == ([{"rows": n, "px": WIN[0] * WIN[1]}] if n else [])
    assert len(seen) == (1 if n else 0)
    if n:
        keep = torch.tensor([i for i in range(b) if active[i]])
        oys, oxs = roi_ops.window_origin(got["box"][keep], *WIN, H, W)
        assert torch.equal(seen[0], roi_ops.crop_windows_batch(prev[keep], oys, oxs, *WIN))
    # the plain K1 indexes each frame once; the active rows' gather twice more
    gathers = _op_names(prof, "nsof.crop").count("aten::index") - (2 if n else 0)
    copies = _op_names(prof, "nsof.deep.flow").count("aten::index_copy_")
    assert (gathers, copies) == ((2, 1) if 0 < n < b else (0, 0))
    for i in range(b):
        one = tdf.deep_roi_flow_step(mem[i], prev[i], nxt[i], TCFG, tbe)
        _close({k: v[i] for k, v in got.items()}, one, BATCH_KEYS)
    if n < b:
        assert not got["flow"][~got["any_active"]].any()
        assert not got["mask"][~got["any_active"]].any()


@pytest.mark.parametrize("task", sorted(ROI_STEPS))
def test_inactive_deep_roi_step_makes_no_backend_call(task, backends):
    """At B = 1 a sample whose box is under 64 px makes no backend call:
    no flow, no mask, no tracked box, the frame passed through unwarped;
    the gate's box and region percentage as the gate computes them."""
    from nsof_tpu_torch.ops import roi as roi_ops

    _, tbe = backends
    step, keys = ROI_STEPS[task]
    mem, prev, nxt, fut = _inputs()
    got = step(mem[2], prev[2], nxt[2], fut[2], TCFG, _spy(tbe, [], refuse=True), tdf)
    roi_cfg = dataclasses.replace(TCFG.roi, memsize=TCFG.roi.memsize // 3)
    box = roi_ops.roi_boxes(torch.from_numpy(mem[2:3]), H, W, roi_cfg)["merged"][0]
    assert not bool(got["any_active"]) and torch.equal(got["box"], box)
    assert float(got["region_pct"]) == float(roi_ops.region_percentage(box, H, W))
    if "flow" in got:
        assert not got["flow"].any()
    if "mask" in got:
        assert not got["mask"].any()
    if "valid" in got:
        assert not got["valid"].any()
    if "pred" in got:
        np.testing.assert_array_equal(got["pred"].numpy(), fut[2])


@pytest.mark.parametrize("shape", [(2, 96, 144, 3), (2, 100, 151, 3)],
                         ids=["divisible", "ragged"])
def test_resize_third_matches_jax(shape):
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, shape).astype(np.uint8)
    want = np.asarray(jdf.resize_third(img))
    got = tdf.resize_third(torch.from_numpy(img))
    assert got.dtype == torch.float32 and got.shape == want.shape
    if shape[1] % 3 == 0 and shape[2] % 3 == 0:
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), img[:, 1::3, 1::3].astype(np.float32))
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_window_larger_than_frame_raises(backends):
    _, tbe = backends
    mem, prev, nxt, fut = _inputs()
    cfg = dataclasses.replace(TCFG, window_h=H + 8)
    with pytest.raises(ValueError, match="larger than"):
        tdf.deep_roi_flow_batch(mem, prev, nxt, cfg, tbe)
    with pytest.raises(ValueError, match="larger than"):
        tdf.deep_roi_prediction_step(mem[0], prev[0], nxt[0], fut[0],
                                     dataclasses.replace(TCFG, window_w=W + 1), tbe)


def test_deep_engine_results_equal_their_batches(backends):
    """Seven requests from seven threads, max_batch 4: each result equals the
    direct ``deep_roi_flow_batch`` of the padded batch it went in."""
    _, tbe = backends
    eng = BatchingEngine.for_deep_backend(TCFG, tbe, max_batch=4, max_wait_ms=50)
    assert eng.mem_grid == (6, 9) and eng.frame_channels == 3 and eng.device == tbe.device
    assert BatchingEngine(TCFG, max_batch=1, device="cpu").mem_grid == (2, 3)
    run, dispatch = eng._run, eng._dispatch
    warm = []
    eng._run = lambda m, p, n: warm.append(m.shape) or run(m, p, n)
    records = []

    def recording_dispatch(batch):
        records.append({"futures": [item[3] for item in batch]})
        dispatch(batch)

    def recording_run(m, p, n):
        records[-1]["inputs"] = (m, p, n)
        return run(m, p, n)

    try:
        _build.reset_launches()
        eng.warmup()
        assert warm == [(k, 6, 9) for k in (1, 2, 4)]
        # every warm-up row is active, so the backend ran on each bucket whole
        assert (_build.COUNTS["deep_flow_rows"], _build.COUNTS["deep_flow_rows_skipped"]) == (7, 0)
        eng._run, eng._dispatch = recording_run, recording_dispatch
        mem, prev, nxt, _ = _inputs()
        reqs = [(mem[i % 3], prev[i % 3], nxt[(i + i // 3) % 3]) for i in range(7)]
        futs = [None] * 7
        threads = [threading.Thread(target=lambda i=i: futs.__setitem__(i, eng.submit(*reqs[i])))
                   for i in range(7)]
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            results = {id(f): f.result(timeout=120) for f in futs}
        finally:
            sys.setswitchinterval(interval)
    finally:
        eng.shutdown()
    assert eng.stats.requests == 7 and eng.stats.dispatches == len(records) < 7
    checked = 0
    for rec in records:
        direct = tdf.deep_roi_flow_batch(*rec["inputs"], TCFG, tbe)
        for row, fut in enumerate(rec["futures"]):
            for k, v in direct.items():
                np.testing.assert_array_equal(results[id(fut)][k], v[row].numpy(), err_msg=k)
            checked += 1
    assert checked == 7
