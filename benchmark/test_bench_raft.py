"""The ``raft.roi`` cell on the CPU at a small cut: a sound run is correct,
the bfloat16 control and each fault are not; the roofline counts against
hand counts; the RAFT readers on a hand-made trace.

The cut: 136×152 frames (17×19 at 1/8, odd at two pyramid levels), a
124×140 window (padded to 128×144), memsize 48 (16-px cells on the deep
grid, 8×9), B = 6; the configuration's 20 iterations, at which the
bfloat16 control's flow is 0.13–0.15 px off here, as on the card.
"""

import copy
import json
import types

import pytest
import torch

from benchmark import common
from benchmark.roofline import raft as roofline_raft
from benchmark.run import Reading
from benchmark.test_bench_cells import _altered, _half_batch
from benchmark.trace import WINDOW, Trace

CELL = "raft.roi"


def small_raft_cell(seed: int = 2**31 + 77) -> common.Cell:
    cell = common.load_cell(CELL, seed, 0.3, False)
    cfg = copy.deepcopy(cell.config)
    cfg.update(image_h=136, image_w=152, window_h=124, window_w=140)
    cfg["roi"]["memsize"] = 48
    cell.config = cfg
    cell.params = dict(cell.params, batch=6, batches=2, check_block=4, object_margin_px=3,
                       block_rows=[2, 3], block_cols=[1, 3])
    cell.device = torch.device("cpu")
    return cell


def run(cell):
    return common.load_module("traffic", cell.traffic).run(cell)


def test_sound_run_is_correct():
    cell = small_raft_cell()
    out = run(cell)
    assert out["attempted"] > 0 and out["failed"] == 0
    assert common.judge(out["checks"], cell.limits), out["checks"]
    assert set(out["checks"]) == set(cell.limits)
    assert out["checks"]["flow_px"] < 1e-4  # the plain port against the plain reference


def test_control_is_not_correct():
    cell = small_raft_cell()
    checks = common.load_module("traffic", cell.traffic).control(cell)
    assert not common.judge(checks, cell.limits), checks


@pytest.mark.parametrize("fault", [_half_batch, _altered])
def test_fault_is_not_correct(fault, monkeypatch):
    from nsof_tpu_torch.pipelines import deep_flow

    monkeypatch.setattr(deep_flow, "deep_roi_flow_batch", fault(deep_flow.deep_roi_flow_batch))
    cell = small_raft_cell()
    out = run(cell)
    assert not common.judge(out["checks"], cell.limits), out["checks"]


def test_inputs_follow_the_seed_and_the_deep_grid():
    drv = common.load_module("traffic", "deep_batch")
    cell = small_raft_cell()
    a = drv.rgb_pairs(2**40 + 3, cell.config, cell.params, 5, "cpu", salt=1)
    b = drv.rgb_pairs(2**40 + 3, cell.config, cell.params, 5, "cpu", salt=1)
    c = drv.rgb_pairs(2**40 + 4, cell.config, cell.params, 5, "cpu", salt=1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[1], c[1])
    assert a[0].shape == (5, 136 // 16, 152 // 16) and a[1].shape == (5, 136, 152, 3)
    # the channels are drawn independently
    assert not torch.equal(a[1][..., 0], a[1][..., 1])


def test_roofline_counts_by_hand():
    cfg = common.read_json(common.ROOT / "benchmark" / "configs" / "raft.json")
    blocks = dict(roofline_raft.encoder_blocks(640, 360, 256))
    # 640×360 → 320×180 → 160×90 → 80×45; layer3.0 at 80×45: a 3×3 96 → 128
    # stride 2, a 3×3 128 → 128, a 1×1 96 → 128 stride 2
    assert blocks["layer3.0"] == 80 * 45 * (128 * 96 * 9 + 128 * 128 * 9 + 128 * 96)
    assert blocks["conv1"] == 320 * 180 * 64 * 3 * 49
    assert roofline_raft.encoder_macs(640, 360, 256) == 15_656_140_800
    # one refinement at one position: the motion encoder (324 → 256, 256 → 192
    # 3×3, 2 → 128 7×7, 128 → 64 3×3, 256 → 126 3×3), six 384 → 128 GRU
    # convolutions of 5 taps, the flow head (128 → 256 3×3, 256 → 2 3×3), the
    # mask head (128 → 256 3×3, 256 → 576)
    by_hand = (82_944 + 442_368 + 12_544 + 73_728 + 290_304 + 6 * 245_760
               + 294_912 + 4_608 + 294_912 + 147_456)
    assert roofline_raft.update_macs(cfg["model"]) == by_hand == 3_118_336
    conv, corr = roofline_raft.pair_counts(cfg)
    assert corr == 2 * 3600**2 * 256
    assert conv == 2 * (3 * 15_656_140_800 + 20 * 3600 * 3_118_336)


def X(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": args}


def test_readers_read_the_raft_spans(tmp_path):
    """One step (0–100 µs) holding the encoder (5–20), the correlation
    (20–30), two lookups (30–40, 60–70) and two updates (40–60, 70–90),
    each launching one kernel; the mfu from the host rate."""
    spans_ = [("nsof.deep_roi_flow_batch", 0, 100), ("nsof.deep.flow", 2, 95),
              ("nsof.raft.encode", 5, 15), ("nsof.raft.corr", 20, 10),
              ("nsof.raft.lookup", 30, 10), ("nsof.raft.update", 40, 20),
              ("nsof.raft.lookup", 60, 10), ("nsof.raft.update", 70, 20)]
    kernels = [(6, 8), (21, 4), (31, 2), (41, 12), (61, 3), (71, 10)]
    evs = [X("user_annotation", WINDOW, 0, 200)]
    evs += [X("user_annotation", n, s, d) for n, s, d in spans_]
    for i, (ts, dur) in enumerate(kernels):
        evs.append(X("cuda_runtime", "cudaLaunchKernel", ts, 1, correlation=i))
        evs.append(X("kernel", f"k{i}", ts + 1, dur, tid=7, correlation=i))
    path = tmp_path / f"{CELL}.trace.json"
    path.write_text(json.dumps({"traceEvents": evs}))
    cfg = common.read_json(common.ROOT / "benchmark" / "configs" / "raft.json")
    cell = types.SimpleNamespace(name=CELL, scratch=tmp_path, config=cfg)
    r = Reading(cell, Trace.from_file(path), 2, {"pairs_per_s": 100.0}, {})
    want = {"encode": 8, "corr": 4, "lookup": 5, "update": 22}
    for part, us in want.items():
        got = common.load_module("layer_metrics", f"raft.{part}.device_ms_per_pair").read(r)
        assert got == pytest.approx(us * 1e-3 / 2), part
    mfu = common.load_module("layer_metrics", "raft.step_mfu").read(r)
    assert mfu == pytest.approx(100.0 * roofline_raft.least_seconds(cfg) * 100.0)
    assert 0 < mfu <= 100
    r.trace = None
    assert common.load_module("layer_metrics", "raft.lookup.device_ms_per_pair").read(r) is None
