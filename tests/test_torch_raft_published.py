"""The port's RAFT with the published pyramid pooling (``corr_pool='floor'``)
against the benchmark's plain reference (``benchmark/reference/raft.py``,
written from the published code, no JAX), and the deep ROI step's spans.

Weights: seeded random weights in raft-things.pth's state-dict layout, the
context encoder's BatchNorm statistics included
(``benchmark.reference.raft.synthetic_state``), loaded into the port through
``load_raft_state``.  Frames 136×152 RGB: 17×19 at 1/8, odd at two levels,
so floor and ceil pooling differ (17, 8, 4, 2 and 19, 9, 4, 2 rows and
columns against 17, 9, 5, 3 and 19, 10, 5, 3); three iterations, B = 2.

Measured here: the flow within 4.5e-6 px of the reference (flows up to
2.4 px); under ``'ceil'`` 0.65 px away; the alternate lookup within 3e-6 px
of the all-pairs one in both modes.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import common
from benchmark.reference import raft as ref_raft
from nsof_tpu_torch.config import config_from_dict
from nsof_tpu_torch.models.convert import load_raft_state
from nsof_tpu_torch.models.raft import RAFT, RaftConfig, build_corr_pyramid
from nsof_tpu_torch.pipelines import deep_flow as tdf
from nsof_tpu_torch.utils import timing
from torch_single_thread import one_torch_thread  # noqa: F401  (autouse)

FLOW_TOL = 1e-4  # px: float32 against float32, different gathers and sums
ITERS = 3
H, W = 136, 152
CONFIG = common.read_json(common.ROOT / "benchmark" / "configs" / "raft.json")
MODEL = dict(CONFIG["model"], iters=ITERS)
STATE = ref_raft.synthetic_state(2**33 + 5, MODEL)


def _port(pool="floor", mode="allpairs"):
    cfg = RaftConfig(iters=ITERS, cnet_norm="frozenbatch", corr_pool=pool, corr_mode=mode)
    return load_raft_state(RAFT(cfg), STATE).eval()


def _frames(b, seed=0):
    rng = np.random.default_rng(seed)
    base = (rng.random((b, H + 8, W + 8, 3)) * 255).astype(np.uint8)
    return (torch.from_numpy(np.ascontiguousarray(base[:, 4:4 + H, 4:4 + W])),
            torch.from_numpy(np.ascontiguousarray(base[:, 3:3 + H, 2:2 + W])))


@pytest.fixture(scope="module")
def flows():
    i1, i2 = _frames(2)
    ref = ref_raft.raft_flow(STATE, i1, i2, MODEL)
    out = {"ref": ref}
    with torch.no_grad():
        for pool in ("floor", "ceil"):
            for mode in ("allpairs", "alternate"):
                out[pool, mode] = _port(pool, mode)(i1, i2, test_mode=True)[1]
    return out


def test_floor_equals_the_published_reference(flows):
    ref = flows["ref"]
    assert ref.shape == (2, H, W, 2) and ref.abs().max() > 1.0
    assert (flows["floor", "allpairs"] - ref).abs().max() < FLOW_TOL


def test_ceil_is_not_the_published_model(flows):
    assert (flows["ceil", "allpairs"] - flows["ref"]).abs().max() > 100 * FLOW_TOL


@pytest.mark.parametrize("pool", ["floor", "ceil"])
def test_alternate_equals_allpairs(flows, pool):
    assert (flows[pool, "alternate"] - flows[pool, "allpairs"]).abs().max() < FLOW_TOL


def test_pyramid_sides_by_mode():
    corr = torch.randn(1, 1, 1, 17, 45)
    assert [p.shape[1:] for p in build_corr_pyramid(corr, 4, "floor")] == [
        (17, 45), (8, 22), (4, 11), (2, 5)]
    assert [p.shape[1:] for p in build_corr_pyramid(corr, 4, "ceil")] == [
        (17, 45), (9, 23), (5, 12), (3, 6)]
    assert torch.equal(build_corr_pyramid(corr, 2, "floor")[1][0],
                       torch.nn.functional.avg_pool2d(corr[0, 0], 2, 2)[0])


def test_floor_raises_where_a_level_is_empty():
    with pytest.raises(ValueError, match="no pixel"):
        build_corr_pyramid(torch.randn(1, 2, 2, 8, 5), 4, "floor")
    assert len(build_corr_pyramid(torch.randn(1, 2, 2, 8, 5), 4, "ceil")) == 4
    i1, i2 = (torch.zeros(1, 64, 64, 3, dtype=torch.uint8),) * 2
    model = load_raft_state(RAFT(RaftConfig(corr_levels=5, cnet_norm="frozenbatch",
                                            corr_pool="floor")),
                            ref_raft.synthetic_state(1, dict(MODEL, corr_levels=5))).eval()
    with pytest.raises(ValueError, match="no pixel"), torch.no_grad():
        model(i1, i2, iters=1, test_mode=True)
    with pytest.raises(ValueError, match="corr_pool"):
        build_corr_pyramid(torch.randn(1, 2, 2, 8, 5), 2, "round")


# ── the deep ROI step ─────────────────────────────────────────────────────


def _step_config():
    """The raft configuration cut to 136×152 frames, a 124×140 window,
    memsize 48 (16-px cells, an 8×9 deep grid)."""
    cfg = copy.deepcopy(CONFIG)
    cfg.update(image_h=H, image_w=W, window_h=124, window_w=140, model=MODEL)
    cfg["roi"]["memsize"] = 48
    keys = ("name", "image_h", "image_w", "roi", "fb", "head", "window_h", "window_w")
    return cfg, config_from_dict({k: cfg[k] for k in keys})


def _step_inputs():
    """Three samples: a block in the middle, one at the bottom-right corner
    (the window's origin clamped), one whose box is under 64 px."""
    prev, nxt = _frames(3, seed=1)
    mem = torch.zeros((3, 8, 9), dtype=torch.uint8)
    mem[0, 2:5, 3:6] = 255
    mem[1, 5:8, 6:9] = 255
    mem[2, 0, 0] = 255
    return mem, prev, nxt


@pytest.fixture(scope="module")
def deep_step():
    cfg, pcfg = _step_config()
    backend = tdf.DeepBackend.from_raft(_port(), iters=ITERS, device="cpu")
    args = _step_inputs()
    got = tdf.deep_roi_flow_batch(*args, pcfg, backend)
    want = ref_raft.roi_step(*args, cfg, STATE)
    return cfg, pcfg, backend, args, got, want


def test_deep_step_equals_the_reference_roi_step(deep_step):
    *_, got, want = deep_step
    assert want["any_active"].tolist() == [True, True, False]
    checks = common.seg_checks(got, want)
    assert checks["gate_rows"] == 0
    assert checks["flow_px"] < FLOW_TOL
    assert checks["mask_px"] == 0
    assert want["mask"][:2].flatten(1).any(dim=1).all()  # the masks are not empty


def _span_tree(prof) -> list:
    def tree(ev):
        out = []
        for c in sorted(ev.cpu_children, key=lambda e: e.time_range.start):
            if c.name.startswith("nsof."):
                out.append((c.name, tree(c)))
            else:
                out.extend(tree(c))
        return out

    roots = [e for e in prof.events() if e.cpu_parent is None]
    return tree(type("Root", (), {"cpu_children": roots})())


def test_deep_step_span_tree_and_outputs_under_the_profiler(deep_step):
    _, pcfg, backend, args, plain, _ = deep_step
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = tdf.deep_roi_flow_batch(*args, pcfg, backend)
    for k in plain:
        assert torch.equal(plain[k], got[k]), k
    raft = ([("nsof.raft.encode", []), ("nsof.raft.corr", [])]
            + [("nsof.raft.lookup", []), ("nsof.raft.update", [])] * ITERS
            + [("nsof.raft.upsample", [])])
    assert _span_tree(prof) == [("nsof.deep_roi_flow_batch", [
        ("nsof.gate", []), ("nsof.crop", []), ("nsof.deep.flow", raft), ("nsof.head", []),
        ("nsof.head", []), ("nsof.scatter", [])])]
    # outside the layer spans the step holds only no-op moves of its inputs
    step = next(e for e in prof.events() if e.name == "nsof.deep_roi_flow_batch")
    outside = [c for c in step.cpu_children if not c.name.startswith("nsof.")]
    assert all(c.name in ("aten::to", "aten::contiguous") and not c.cpu_children
               for c in outside), [c.name for c in outside]


def test_tracing_off_opens_no_range(deep_step, monkeypatch):
    _, pcfg, backend, args, plain, _ = deep_step

    def refuse(*a, **k):
        raise AssertionError("a record_function range was opened with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert timing.span("nsof.raft.update") is timing.span("nsof.gate")
    got = tdf.deep_roi_flow_batch(*args, pcfg, backend)
    assert all(torch.equal(plain[k], got[k]) for k in plain)


def test_pretrained_raft_keeps_ceil():
    from nsof_tpu_torch.models.convert import infer_raft_config

    cfg = infer_raft_config(STATE)
    assert (cfg.corr_pool, cfg.cnet_norm, cfg.small) == ("ceil", "frozenbatch", False)
    model = RAFT(dataclasses.replace(cfg, corr_pool="floor"))
    assert load_raft_state(model, STATE).cfg.corr_pool == "floor"
