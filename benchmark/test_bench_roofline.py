"""The yardstick's arithmetic on hand-worked cases: the roofline counts and
the reading of a profiler trace."""

import json

import pytest

from benchmark import common, roofline
from benchmark.trace import WINDOW, Trace


def tiny(**kw):
    cfg = common.read_json(common.ROOT / "benchmark" / "configs" / "autodriving.json")
    cfg.update(image_h=32, image_w=32, window_h=32, window_w=32, warp_radius=1)
    cfg["fb"] = dict(cfg["fb"], levels=0, **kw)
    return cfg


def test_tree_adds_and_levels():
    assert [roofline.tree_adds(w) for w in (1, 3, 15, 16)] == [0, 2, 6, 4]
    cfg = common.read_json(common.ROOT / "benchmark" / "configs" / "grasp.json")
    assert roofline.levels(cfg) == [(1920, 1080), (960, 540), (480, 270), (240, 135)]
    cfg = common.read_json(common.ROOT / "benchmark" / "configs" / "autodriving.json")
    assert roofline.levels(cfg) == [(801, 801), (481, 481), (288, 288), (173, 173)]


def test_k5_counts_one_level():
    # 32 × 32, radius 1: 4 taps, warp 4·14·(1 + 4/32) + 4·14 + 34 = 153 a pixel;
    # bytes: flow 8, border scale 4, r0 20, r1 5·35·35·4, M 20
    ops, nbytes = roofline.k5_counts(tiny(iterations=1))
    assert ops == 1024 * 153
    assert nbytes == 1024 * 8 + 1024 * 4 + 1024 * 20 + 5 * 35 * 35 * 4 + 1024 * 20


def test_k4_counts_one_level():
    # winsize 3: box 5·(2 + 2 + 1) + 11 = 36; one launch with the next M
    # (its tile halo 1 + 4/32 on the box sum) and one with the flow
    ops, nbytes = roofline.k4_counts(tiny(iterations=2, winsize=3))
    assert ops == 1024 * (36 * (1 + 4 / 32) + 153) + 1024 * 36
    mats = 1024 * 10 + 1024 * 20 + 5 * 35 * 35 * 4 + 1024 * 4 + 1024 * 10
    assert nbytes == mats + 1024 * 10 + 1024 * 8


def test_step_bytes_and_least_time():
    cfg = tiny()
    _, nbytes = roofline.step_counts(cfg, "batch", {})
    gh = 32 // cfg["roi"]["memsize"]
    assert nbytes == 2 * 1024 + gh * gh + 1024 + 1024 * 8 + 21
    assert roofline.least_seconds(roofline.F32_FLOPS, 0) == 1.0
    assert roofline.least_seconds(0, roofline.HBM_BYTES_PER_S) == 1.0


def X(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
            "args": args}


def test_trace_reading():
    ff = "repo/nsof_tpu_torch/ops/farneback_fast.py(10): farneback_fast"
    mf = "repo/nsof_tpu_torch/ops/morphology_fast.py(5): dilate"
    ev = [X("user_annotation", WINDOW, 0, 100),
          X("python_function", ff, 5, 40), X("python_function", mf, 50, 30),
          X("cpu_op", "aten::foo", 40, 15),
          X("cuda_runtime", "cudaLaunchKernel", 10, 1, correlation=1),
          X("cuda_runtime", "cudaLaunchKernel", 20, 1, correlation=2),
          X("cuda_runtime", "cudaLaunchKernel", 60, 1, correlation=3),
          X("kernel", "kA", 12, 10, tid=7, correlation=1),
          X("kernel", "kB", 22, 10, tid=7, correlation=2),
          X("kernel", "kC", 62, 20, tid=7, correlation=3),
          X("gpu_memcpy", "Memcpy", 90, 5, tid=7, correlation=4),
          X("kernel", "outside", 150, 10, tid=7, correlation=9)]
    t = Trace(ev)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(45e-6)
    assert len(t.kernels) == 3
    assert t.kernel_seconds("kC") == (pytest.approx(20e-6), 1)
    assert t.module_seconds(["ops/farneback_fast.py"]) == pytest.approx(20e-6)
    assert t.module_seconds(["ops/morphology_fast.py"]) == pytest.approx(20e-6)
    b = t.breakdown()
    assert b["device_ops"][0] == ["kC", pytest.approx(20e-6)]
    gaps = dict((n, v) for n, v in b["idle_gaps"])
    assert gaps["aten::foo"] == pytest.approx(30e-6)
    assert gaps[ff[:120]] == pytest.approx(12e-6)
    assert sum(gaps.values()) == pytest.approx(55e-6)
    no_stacks = Trace([e for e in ev if e["cat"] != "python_function"])
    assert no_stacks.module_seconds(["ops/farneback_fast.py"]) is None


def test_trace_without_its_window_is_refused():
    with pytest.raises(ValueError):
        Trace([X("kernel", "k", 0, 1)])
    json.dumps(Trace([X("user_annotation", WINDOW, 0, 10)]).breakdown())
