"""The port's layer spans (``nsof_tpu_torch/utils/timing.py::span``).

With no profiler ``span`` is one shared no-op context.  Under
``torch.profiler`` on the CPU ``seg_batch_fast`` emits exactly its span
tree, on the fused route (grasp preset) and on the level route (autodriving
preset): ``nsof.seg_batch_fast`` holding ``nsof.gate``, ``nsof.crop``,
``nsof.farneback`` (on the fused route one ``nsof.farneback.pyramid`` a
cascade level, then ``pyramid``, ``expand`` and ``update`` a pyramid level
on both routes), ``nsof.head`` and ``nsof.scatter``, one per call; its
outputs are bit-equal with and without the profiler, and every operator
that does work sits inside a layer span.  ``stream_masks`` holds the frame
simulation's spans and that tree inside ``nsof.stream_masks``.  On the
card (``-m cuda``) every device operation of a traced ``seg_batch_fast``
is charged by correlation id to a layer span, K4's to
``nsof.farneback.update``.  Sizes: 128×160 frames, memsize 32, a 128×128
window (levels 0–2 on both presets), B = 4.

The work counters (``timing.count``): nothing is recorded without a
profiler; under one, a ``seg_batch_fast`` call and a deep ROI step (a stub
backend on 96×144 RGB frames, a 60×90 window the backend sees padded to
64×96) each record one ``nsof.gate`` and one ``nsof.flow`` entry, B = 4 with
row 0 inactive (the Farnebäck flow computes 4 rows, the deep backend the 3
active ones), and their outputs are bit-equal to those of an unprofiled
call; the kept area from box and window coordinates
(``benchmark/counts.py::kept_px``) equals the summed box mask of the active
rows; the record keeps the newest 64 entries a name.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nsof_tpu_torch.config import DATASETS
from nsof_tpu_torch.device.frame_sim import FrameSimConfig
from nsof_tpu_torch.ops import farneback_fast as tff
from nsof_tpu_torch.ops.farneback import _effective_levels
from nsof_tpu_torch.ops import roi as roi_ops
from nsof_tpu_torch.pipelines import deep_flow as tdf
from nsof_tpu_torch.pipelines import stream as tstream
from nsof_tpu_torch.pipelines.segmentation import seg_batch_fast
from nsof_tpu_torch.utils import timing
from torch_single_thread import one_torch_thread  # noqa: F401  (autouse)

from benchmark.counts import kept_px

H, W, MEMSIZE, WIN, B = 128, 160, 32, 128, 4
LAYERS = ("nsof.gate", "nsof.crop", "nsof.farneback", "nsof.head", "nsof.scatter")


def _cfg(preset):
    cfg = dataclasses.replace(DATASETS[preset], name=f"{preset}128", image_h=H, image_w=W,
                              window_h=WIN, window_w=WIN, warp_radius=3)
    return dataclasses.replace(cfg, roi=dataclasses.replace(cfg.roi, memsize=MEMSIZE))


def _frames(t, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.random((H + 64, W + 64)).astype(np.float32) * 255
    return torch.from_numpy(np.stack([base[16 + 2 * v : 16 + 2 * v + H, 16 + v : 16 + v + W]
                                      for v in range(t)]).astype(np.uint8))


def _inputs():
    frames = _frames(B + 1)
    mem = torch.zeros((B, H // MEMSIZE, W // MEMSIZE), dtype=torch.uint8)
    for i in range(1, B):
        mem[i, i % 3 : i % 3 + 2, i : i + 2] = 255  # sample 0: no active cell
    return mem, frames[:-1], frames[1:]


def _span_tree(prof) -> list:
    """The ``nsof.*`` ranges of a profile as nested ``(name, [children])``."""
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


def _farneback_tree(preset):
    fb = DATASETS[preset].fb
    levels = _effective_levels(WIN, WIN, fb.levels, fb.pyr_scale)
    per_level = [("nsof.farneback.pyramid", []), ("nsof.farneback.expand", []),
                 ("nsof.farneback.update", [])]
    cascade = ([("nsof.farneback.pyramid", [])] * levels
               if tff.route("auto", fb) == "fused" else [])
    return cascade + per_level * (levels + 1)


def _seg_tree(preset):
    return ("nsof.seg_batch_fast", [("nsof.gate", []), ("nsof.crop", []),
                                    ("nsof.farneback", _farneback_tree(preset)),
                                    ("nsof.head", []), ("nsof.scatter", [])])


@pytest.fixture(scope="module", params=["grasp", "autodriving"])
def traced_seg(request):
    preset = request.param
    cfg, args = _cfg(preset), _inputs()
    plain = seg_batch_fast(*args, cfg, return_flow=True, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = seg_batch_fast(*args, cfg, return_flow=True, device="cpu")
    return preset, plain, got, prof


def test_span_is_a_shared_noop_without_a_profiler():
    assert timing.span("nsof.gate") is timing.span("nsof.scatter")
    with timing.span("nsof.gate") as got:
        assert got is None
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(timing.span("nsof.gate"), torch.profiler.record_function)


def test_routes_as_named(traced_seg):
    preset = traced_seg[0]
    assert tff.route("auto", DATASETS[preset].fb) == (
        "fused" if preset == "grasp" else "pallas_sep")


def test_outputs_bit_equal_under_the_profiler(traced_seg):
    _, plain, got, _ = traced_seg
    assert plain.keys() == got.keys()
    for k in plain:
        assert torch.equal(plain[k], got[k]), k
    assert bool(got["any_active"][1:].all()) and not bool(got["any_active"][0])


def test_seg_batch_fast_span_tree(traced_seg):
    preset, _, _, prof = traced_seg
    assert _span_tree(prof) == [_seg_tree(preset)]


def test_every_working_op_sits_in_a_layer_span(traced_seg):
    """Outside the layer spans the step holds only ``aten::to`` calls that
    return their input (the inputs are already on the device, as uint8)."""
    prof = traced_seg[3]
    step = next(e for e in prof.events() if e.name == "nsof.seg_batch_fast")
    assert [c.name for c in step.cpu_children if c.name.startswith("nsof.")] == list(LAYERS)
    outside = [c for c in step.cpu_children if not c.name.startswith("nsof.")]
    assert outside and all(c.name == "aten::to" and not c.cpu_children for c in outside), \
        [(c.name, [g.name for g in c.cpu_children]) for c in outside]
    n_ops = sum(1 for e in prof.events() if e.name.startswith("aten::"))
    assert n_ops > 100


def test_stream_masks_nests_the_frame_sim_and_the_seg_tree():
    cfg = _cfg("grasp")
    sim = FrameSimConfig(m=MEMSIZE, n=MEMSIZE, n_substeps=10)
    frames = _frames(4, seed=1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tstream.stream_masks(frames, cfg, sim, return_flow=True, device="cpu")
    assert _span_tree(prof) == [("nsof.stream_masks", [
        ("nsof.frame_sim.compress", []), ("nsof.frame_sim.scan", []), _seg_tree("grasp")])]


def _profiled(fn):
    """``fn()`` under the profiler → (result, its gate entries, its flow
    entries)."""
    timing.reset_counts()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, timing.counted("nsof.gate"), timing.counted("nsof.flow")


def _assert_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_equal(x, y)
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    else:
        assert a == b


def _assert_kept_px(entry):
    wh, ww = entry["win"]
    mask = (roi_ops.window_box_mask(entry["box"], entry["oys"], entry["oxs"], wh, ww)
            & entry["active"].bool()[:, None, None])
    assert kept_px(entry) == int(mask.sum())


def test_count_records_nothing_without_a_profiler():
    timing.reset_counts()
    timing.count("nsof.test", rows=1)
    assert timing.counted("nsof.test") == []
    with profile(activities=[ProfilerActivity.CPU]):
        timing.count("nsof.test", rows=2)
    timing.count("nsof.test", rows=3)
    assert timing.counted("nsof.test") == [{"rows": 2}]
    timing.reset_counts()
    assert timing.counted("nsof.test") == []


def test_count_keeps_the_newest_64_entries():
    timing.reset_counts()
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(70):
            timing.count("nsof.test", rows=i)
    assert timing.COUNT_KEEP == 64
    assert [e["rows"] for e in timing.counted("nsof.test")] == list(range(6, 70))
    timing.reset_counts()


@pytest.mark.parametrize("preset", ["grasp", "autodriving"])
def test_seg_batch_fast_counts_its_gate_and_flow_once(preset):
    cfg, args = _cfg(preset), _inputs()
    plain = seg_batch_fast(*args, cfg, return_flow=True, device="cpu")
    got, gate, flow = _profiled(
        lambda: seg_batch_fast(*args, cfg, return_flow=True, device="cpu"))
    _assert_equal(plain, got)
    assert len(gate) == 1 and len(flow) == 1
    g = gate[0]
    assert g["rows"] == B and g["win"] == (WIN, WIN)
    assert g["active"] is got["any_active"] and g["box"] is got["box"]
    assert g["active"].tolist() == [False, True, True, True]
    assert flow[0] == {"rows": B, "px": WIN * WIN}
    _assert_kept_px(g)
    assert 0 < kept_px(g) < B * WIN * WIN
    timing.reset_counts()


DEEP_H, DEEP_W, DEEP_WIN = 96, 144, (60, 90)


def _deep_cfg():
    cfg = dataclasses.replace(DATASETS["grasp"], image_h=DEEP_H, image_w=DEEP_W,
                              window_h=DEEP_WIN[0], window_w=DEEP_WIN[1])
    return dataclasses.replace(cfg, roi=dataclasses.replace(cfg.roi, memsize=48))


def _deep_inputs():
    """B = 4 RGB pairs on the 6×9 grid of 16-px cells: row 0 no active
    cell, rows 1–3 blocks of at least 4×4 cells (64 px), one in the corner."""
    rng = np.random.default_rng(5)
    base = (rng.random((B, DEEP_H + 4, DEEP_W + 4, 3)) * 255).astype(np.uint8)
    prev = torch.from_numpy(np.ascontiguousarray(base[:, 2:2 + DEEP_H, 2:2 + DEEP_W]))
    nxt = torch.from_numpy(np.ascontiguousarray(base[:, 1:1 + DEEP_H, 3:3 + DEEP_W]))
    mem = torch.zeros((B, 6, 9), dtype=torch.uint8)
    mem[1, 1:5, 1:6] = 255
    mem[2, 2:6, 4:9] = 255
    mem[3, 0:4, 0:4] = 255
    return mem, prev, nxt


def test_deep_roi_gate_counts_its_gate_and_flow_once():
    stub = tdf.DeepBackend(apply=lambda a, b: (b.float() - a.float())[..., :2],
                           device=torch.device("cpu"), model=torch.nn.Identity(), name="stub")
    cfg, args = _deep_cfg(), _deep_inputs()
    plain = tdf._deep_roi_gate(*args, cfg, stub)
    got, gate, flow = _profiled(lambda: tdf._deep_roi_gate(*args, cfg, stub))
    _assert_equal(plain, got)
    assert len(gate) == 1 and len(flow) == 1
    g = gate[0]
    assert g["rows"] == B and g["win"] == DEEP_WIN and g["active"] is got["any_active"]
    assert g["active"].tolist() == [False, True, True, True]
    # the backend ran on the three active rows, the window padded to /8
    assert flow[0] == {"rows": B - 1, "px": 64 * 96}
    _assert_kept_px(g)
    assert int(got["inbox"].sum()) == kept_px(g) > 0
    timing.reset_counts()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_every_kernel_is_charged_to_a_layer_span_cuda(cuda_device, tmp_path):
    from benchmark.spans import Spans
    from benchmark.trace import traced

    cfg = _cfg("grasp")
    args = [x.to(cuda_device) for x in _inputs()]
    seg_batch_fast(*args, cfg, return_flow=True)  # builds the kernels, uploads constants
    with traced(tmp_path / "seg.trace.json", with_stack=False) as got:
        seg_batch_fast(*args, cfg, return_flow=True)
    spans = Spans(got[0])
    assert spans.steps and len(spans.ops) > 50
    missed = [op[2] for op, path in spans.ops if len(path) < 2 or path[1] not in LAYERS]
    assert not missed, missed
    k4 = [path for op, path in spans.ops if "fused_box_update_kernel" in op[2]]
    assert k4 and all(p[-1] == "nsof.farneback.update" for p in k4)
