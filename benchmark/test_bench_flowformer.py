"""The ``flowformer.roi`` cell on the CPU at a small cut: a sound run is
correct, the bfloat16 control and each fault are not; the roofline counts
against hand counts; the FlowFormer readers on a hand-made trace.

The cut: 112×128 frames, a 96×112 window (Twins grids 24×28 at sr 8 and
12×14 at sr 4, so the published sub-sampling matters), memsize 48 (16-px
cells on the deep grid, 7×8), B = 6; the configuration's 32 decoder steps.
"""

import copy
import json
import types

import pytest
import torch

from benchmark import common
from benchmark.roofline import flowformer as roofline_ff
from benchmark.run import Reading
from benchmark.test_bench_cells import _altered, _half_batch
from benchmark.trace import WINDOW, Trace

CELL = "flowformer.roi"


def small_ff_cell(seed: int = 2**31 + 77) -> common.Cell:
    cell = common.load_cell(CELL, seed, 0.3, False)
    cfg = copy.deepcopy(cell.config)
    cfg.update(image_h=112, image_w=128, window_h=96, window_w=112)
    cfg["roi"]["memsize"] = 48
    cell.config = cfg
    cell.params = dict(cell.params, batch=6, batches=2, check_block=4, object_margin_px=3,
                       block_rows=[2, 3], block_cols=[2, 3])
    cell.device = torch.device("cpu")
    return cell


def run(cell):
    return common.load_module("traffic", cell.traffic).run(cell)


def test_sound_run_is_correct():
    cell = small_ff_cell()
    out = run(cell)
    assert out["attempted"] > 0 and out["failed"] == 0
    assert common.judge(out["checks"], cell.limits), out["checks"]
    assert set(out["checks"]) == set(cell.limits)
    assert out["checks"]["flow_px"] < 1e-4  # the plain port against the plain reference


def test_control_is_not_correct():
    cell = small_ff_cell()
    checks = common.load_module("traffic", cell.traffic).control(cell)
    assert not common.judge(checks, cell.limits), checks


@pytest.mark.parametrize("fault", [_half_batch, _altered])
def test_fault_is_not_correct(fault, monkeypatch):
    from nsof_tpu_torch.pipelines import deep_flow

    monkeypatch.setattr(deep_flow, "deep_roi_flow_batch", fault(deep_flow.deep_roi_flow_batch))
    cell = small_ff_cell()
    out = run(cell)
    assert not common.judge(out["checks"], cell.limits), out["checks"]


def test_the_parent_port_fails_at_once(monkeypatch):
    """A port whose FlowFormerConfig has no ``gsa_pad`` fails before any
    work."""
    import dataclasses

    from nsof_tpu_torch.models import flowformer

    fields = {f.name: f.default for f in dataclasses.fields(flowformer.FlowFormerConfig)
              if f.name != "gsa_pad"}
    monkeypatch.setattr(flowformer, "FlowFormerConfig",
                        dataclasses.make_dataclass("FlowFormerConfig", list(fields)))
    with pytest.raises(TypeError, match="gsa_pad"):
        run(small_ff_cell())


def test_roofline_counts_by_hand():
    cfg = common.read_json(common.ROOT / "benchmark" / "configs" / "flowformer.json")
    m = cfg["model"]
    parts = {name: (conv, mm) for name, conv, mm in roofline_ff.twins_blocks(640, 360)}
    # stage 1 at 640×360: a 160×90 grid of 128 channels; the LSA on it padded
    # to 161×91 (23×13 windows of 49), the GSA's keys 20×11 (floor at sr 8)
    n, c = 160 * 90, 128
    lsa = 161 * 91 * c * 3 * c + 299 * 2 * 49 * 49 * c + n * c * c + 8 * n * c * c
    gsa = n * c * c + 220 * c * 2 * c + 2 * n * 220 * c + n * c * c + 8 * n * c * c
    assert parts["stage0.lsa"] == (0, lsa) == (0, 3_027_274_496)
    assert parts["stage0.gsa"] == (220 * c * c * 64, gsa)
    assert parts["stage1.patch_embed"] == (80 * 45 * 256 * 128 * 4, 0)
    # one 80×45 cost map, padded to 80×48: 40×24×16 (1 → 16), 20×12×32, 10×6×64
    # of 6×6 taps, then two 1×1 convolutions of 128 → 128 at 10×6
    by_hand = (40 * 24 * 16 * 36 + 20 * 12 * 32 * 16 * 36 + 10 * 6 * 64 * 32 * 36
               + 2 * 60 * 128 * 128)
    assert roofline_ff.cost_map_macs(80, 45, m) == by_hand == 11_366_400
    # one decoder step at one position: the flow token (81 → 64 → 64), the
    # motion encoder (145 → 256, 256 → 192 3×3, 2 → 128 7×7, 128 → 64 3×3,
    # 256 → 126 3×3), GMA's value (128 → 128), six 512 → 128 GRU convolutions
    # of 5 taps, the flow head and the mask head; the cross attention (q 64 ×
    # 64, 8 keys × 64 twice, the 128 → 64 projection, the 64 → 64 FFN twice)
    # and the aggregation over 3,600 positions of 128
    conv = (81 * 64 + 64 * 64 + 145 * 256 + 256 * 192 * 9 + 2 * 128 * 49 + 128 * 64 * 9
            + 256 * 126 * 9 + 128 * 128 + 6 * 512 * 128 * 5 + 128 * 256 * 9 + 256 * 2 * 9
            + 128 * 256 * 9 + 256 * 576)
    mm = 64 * 64 + 2 * 8 * 64 + 128 * 64 + 2 * 64 * 64 + 3600 * 128
    assert roofline_ff.step_macs(m, 3600) == (conv, mm) == (3_589_696, 482_304)
    conv_flops, mm_flops = roofline_ff.pair_counts(cfg)
    assert 32 * 3600 * 2 * conv < conv_flops < 1.2 * 32 * 3600 * 2 * conv
    assert roofline_ff.least_seconds(cfg) == pytest.approx(
        conv_flops / roofline_ff.TF32_FLOPS + mm_flops / roofline_ff.F32_FLOPS)


def X(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": args}


def test_readers_read_the_flowformer_spans(tmp_path):
    """One step (0–100 µs) holding the encoders (5–20), the memory (20–30),
    and two decoder steps (lookup, query, update: 30–60, 60–90), each span
    launching one kernel; the mfu from the host rate."""
    spans_ = [("nsof.deep_roi_flow_batch", 0, 100), ("nsof.deep.flow", 2, 95),
              ("nsof.flowformer.encode", 5, 15), ("nsof.flowformer.memory", 20, 10),
              ("nsof.flowformer.lookup", 30, 5), ("nsof.flowformer.query", 35, 5),
              ("nsof.flowformer.update", 40, 20), ("nsof.flowformer.lookup", 60, 5),
              ("nsof.flowformer.query", 65, 5), ("nsof.flowformer.update", 70, 20)]
    kernels = [(6, 8), (21, 4), (31, 2), (36, 3), (41, 12), (61, 3), (66, 1), (71, 10)]
    evs = [X("user_annotation", WINDOW, 0, 200)]
    evs += [X("user_annotation", n, s, d) for n, s, d in spans_]
    for i, (ts, dur) in enumerate(kernels):
        evs.append(X("cuda_runtime", "cudaLaunchKernel", ts, 1, correlation=i))
        evs.append(X("kernel", f"k{i}", ts + 1, dur, tid=7, correlation=i))
    path = tmp_path / f"{CELL}.trace.json"
    path.write_text(json.dumps({"traceEvents": evs}))
    cfg = common.read_json(common.ROOT / "benchmark" / "configs" / "flowformer.json")
    cell = types.SimpleNamespace(name=CELL, scratch=tmp_path, config=cfg)
    r = Reading(cell, Trace.from_file(path), 2, {"pairs_per_s": 10.0}, {})
    want = {"encode": 8, "memory": 4, "lookup": 5, "query": 4, "update": 22}
    for part, us in want.items():
        got = common.load_module("layer_metrics", f"flowformer.{part}.device_ms_per_pair").read(r)
        assert got == pytest.approx(us * 1e-3 / 2), part
    mfu = common.load_module("layer_metrics", "flowformer.step_mfu").read(r)
    assert mfu == pytest.approx(100.0 * roofline_ff.least_seconds(cfg) * 10.0)
    assert 0 < mfu <= 100
    raft_cfg = common.read_json(common.ROOT / "benchmark" / "configs" / "raft.json")
    r.cell = types.SimpleNamespace(name="raft.roi", scratch=tmp_path, config=raft_cfg)
    assert common.load_module("layer_metrics", "flowformer.step_mfu").read(r) is None
    r.trace = None
    reader = common.load_module("layer_metrics", "flowformer.query.device_ms_per_pair")
    assert reader.read(r) is None
