"""The ``sam_vit_h.gt`` cell on the CPU at a small cut: a sound run is
correct, the bfloat16 control and each fault are not, a port without the
batched step fails at once; the roofline counts against hand counts; the
SAM readers on a hand-made trace.

The cut: 200×112 frames (the longest side to 160: 160×90, zero-padded to
160²), the encoder at width 64 (4 heads), depth 2 (block 0 windowed at
window 4, block 1 global): a 10×10 token grid, zero-padded to 12×12 for the
windows, so the padding matters; the decoder at its published widths; B =
4 with 1, 3, 0 and 2 boxes, objects of 12–60 px.
"""

import copy
import json
import types

import pytest
import torch
import torch.nn.functional as F

from benchmark import common
from benchmark.roofline import sam as roofline_sam
from benchmark.run import Reading
from benchmark.trace import WINDOW, Trace

CELL = "sam_vit_h.gt"


def small_sam_cell(seed: int = 2**31 + 77) -> common.Cell:
    cell = common.load_cell(CELL, seed, 0.3, False)
    cfg = copy.deepcopy(cell.config)
    cfg.update(image_h=200, image_w=112)
    cfg["model"].update(encoder_embed_dim=64, encoder_depth=2, encoder_num_heads=4,
                        encoder_global_attn_indexes=[1], window_size=4, image_size=160)
    cell.config = cfg
    cell.params = dict(cell.params, batch=4, batches=2, boxes_per_frame=[1, 3, 0, 2],
                       object_px=[12, 60], margin_px=[0, 3], check_block=2)
    cell.device = torch.device("cpu")
    return cell


def run(cell):
    return common.load_module("traffic", cell.traffic).run(cell)


def test_sound_run_is_correct():
    cell = small_sam_cell()
    out = run(cell)
    assert out["attempted"] > 0 and out["failed"] == 0
    assert common.judge(out["checks"], cell.limits), out["checks"]
    assert set(out["checks"]) == set(cell.limits)
    assert out["checks"]["logit_rel"] < 1e-5  # the plain port against the plain reference
    assert out["counters"] == {"sam_frames": 4.0, "sam_boxes": 6.0}


def test_control_is_not_correct():
    cell = small_sam_cell()
    checks = common.load_module("traffic", cell.traffic).control(cell)
    assert not common.judge(checks, cell.limits), checks


def _no_global_bias(monkeypatch):
    """The global blocks' relative-position bias dropped (the windowed
    blocks' table has the window's length, 4)."""
    from nsof_tpu_torch.models import sam as tsam

    real = tsam.rel_pos_table
    monkeypatch.setattr(tsam, "rel_pos_table", lambda rel, q, k: (
        real(rel, q, k) if q == 4 else torch.zeros_like(real(rel, q, k))))


def _edge_padded_windows(monkeypatch):
    """The port's windowed blocks fold windows from the token grid padded
    with its edge tokens, not zeros (the reference keeps ``F.pad``'s
    zeros: the fault is patched into the port's block alone)."""
    from nsof_tpu_torch.models import sam as tsam

    def forward(self, x):
        shortcut, x = x, self.norm1(x)
        ws = self.window_size
        if ws > 0:
            b, h, w, c = x.shape
            hp, wp = h + (-h) % ws, w + (-w) % ws
            xp = F.pad(x.permute(0, 3, 1, 2), (0, wp - w, 0, hp - h), mode="replicate")
            xw = xp.permute(0, 2, 3, 1).reshape(b, hp // ws, ws, wp // ws, ws, c)
            aw = self.attn(xw.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c))
            aw = aw.view(b, hp // ws, wp // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
            x = aw.reshape(b, hp, wp, c)[:, :h, :w]
        else:
            x = self.attn(x)
        x = shortcut + x
        return x + self.mlp(self.norm2(x))

    monkeypatch.setattr(tsam.Block, "forward", forward)


def _frame_zero(monkeypatch):
    """Every box decoded against the first frame's embedding."""
    from nsof_tpu_torch.models import sam as tsam

    real = tsam.decode_prompts

    def decode(model, emb, *args, image_index=None, **kw):
        return real(model, emb, *args, image_index=torch.zeros_like(image_index), **kw)

    monkeypatch.setattr(tsam, "decode_prompts", decode)


@pytest.mark.parametrize("fault", [_no_global_bias, _edge_padded_windows, _frame_zero])
def test_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    cell = small_sam_cell()
    out = run(cell)
    assert not common.judge(out["checks"], cell.limits), out["checks"]


def test_the_parent_port_fails_at_once(monkeypatch):
    """A port whose ground-truth tooling has no batched step fails before
    any weight is drawn."""
    from benchmark.reference import sam as ref_sam
    from nsof_tpu_torch.data import gt_tooling

    monkeypatch.delattr(gt_tooling, "sam_gt_batch")
    monkeypatch.setattr(ref_sam, "synthetic_state", lambda *a, **k: pytest.fail("drew weights"))
    with pytest.raises(ImportError, match="sam_gt_batch"):
        run(small_sam_cell())


def test_roofline_counts_by_hand():
    cfg = common.read_json(common.ROOT / "benchmark" / "configs" / "sam_vit_h.json")
    params = common.read_json(common.ROOT / "benchmark" / "workloads" / f"{CELL}.json")["params"]
    m = cfg["model"]
    parts = {name: (conv, mm) for name, conv, mm in roofline_sam.encoder_blocks(m)}
    # a windowed block: qkv and the projection on the 70x70 padded grid
    # (4,900 tokens), the MLP on 64x64; 25 windows of 196 tokens attend
    # (QK^T and AV, 16 heads of 80); q·R_h and q·R_w against 14 keys a side
    window = 4900 * 1280 * (3 * 1280 + 1280) + 4096 * 2 * 1280 * 5120
    window += 25 * 2 * 196 * 196 * 1280 + 2 * 4900 * 14 * 1280
    glob = 4096 * 1280 * (4 * 1280 + 2 * 5120) + 2 * 4096 * 4096 * 1280 + 2 * 4096 * 64 * 1280
    assert parts["block0.window"] == (0, window) == (0, 88_433_971_200)
    assert parts["block7.global"] == (0, glob) == (0, 124_151_398_400)
    assert parts["patch_embed"] == (4096 * 1280 * 3 * 256, 0)
    assert parts["neck"] == (4096 * 256 * 1280 + 4096 * 256 * 256 * 9, 0)
    total = sum(mm for _, mm in parts.values())
    assert total == 28 * window + 4 * glob
    assert 2.96e12 < total < 2.98e12  # ≈ 2.97 T multiply-adds a 1024² frame
    conv, mm = roofline_sam.decoder_macs(m)
    assert conv == 128 * 128 * 64 * 256 + 256 * 256 * 32 * 64
    assert 1.3e9 < mm < 1.5e9  # ≈ 1.4 G a box: the two-way transformer and the heads
    conv_flops, mm_flops = roofline_sam.frame_counts(cfg, params)
    assert mm_flops == 2 * (total + 2.5 * mm)  # 20 boxes over 8 frames
    assert roofline_sam.least_seconds(cfg, params) == pytest.approx(
        conv_flops / roofline_sam.TF32_FLOPS + mm_flops / roofline_sam.F32_FLOPS)
    assert 0.088 < roofline_sam.least_seconds(cfg, params) < 0.090


def X(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": args}


def test_readers_read_the_sam_spans(tmp_path):
    """One step (0–100 µs) holding the preprocessing (2–6), the encoder
    (6–80: two windowed blocks and a global one), the decoding (80–90)
    and the postprocessing (90–98), each span launching one kernel; the
    mfu from the host rate."""
    spans_ = [("nsof.sam_gt_batch", 0, 100), ("nsof.sam.preprocess", 2, 4),
              ("nsof.sam.encode", 6, 74), ("nsof.sam.encode.window", 8, 20),
              ("nsof.sam.encode.global", 30, 20), ("nsof.sam.encode.window", 52, 20),
              ("nsof.sam.decode", 80, 10), ("nsof.sam.postprocess", 90, 8)]
    kernels = [(3, 2), (7, 1), (9, 10), (31, 16), (53, 10), (81, 6), (91, 4)]
    evs = [X("user_annotation", WINDOW, 0, 200)]
    evs += [X("user_annotation", n, s, d) for n, s, d in spans_]
    for i, (ts, dur) in enumerate(kernels):
        evs.append(X("cuda_runtime", "cudaLaunchKernel", ts, 1, correlation=i))
        evs.append(X("kernel", f"k{i}", ts + 1, dur, tid=7, correlation=i))
    path = tmp_path / f"{CELL}.trace.json"
    path.write_text(json.dumps({"traceEvents": evs}))
    cell = common.load_cell(CELL, 1, 1, True)
    cell.scratch = tmp_path
    r = Reading(cell, Trace.from_file(path), 2, {"pairs_per_s": 5.0}, {})
    want = {"preprocess": 2, "encode.window": 20, "encode.global": 16, "decode": 6,
            "postprocess": 4}
    for part, us in want.items():
        got = common.load_module("layer_metrics", f"sam.{part}.device_ms_per_pair").read(r)
        assert got == pytest.approx(us * 1e-3 / 2), part
    mfu = common.load_module("layer_metrics", "sam.step_mfu").read(r)
    assert mfu == pytest.approx(100.0 * roofline_sam.least_seconds(cell.config, cell.params) * 5)
    assert 0 < mfu <= 100
    assert common.load_module("layer_metrics", "step.syncs_per_call").read(r) == 0
    ff = common.read_json(common.ROOT / "benchmark" / "configs" / "flowformer.json")
    r.cell = types.SimpleNamespace(name="flowformer.roi", scratch=tmp_path, config=ff)
    assert common.load_module("layer_metrics", "sam.step_mfu").read(r) is None
    r.trace = None
    assert common.load_module("layer_metrics", "sam.decode.device_ms_per_pair").read(r) is None
