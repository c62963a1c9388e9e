"""Each cell's driver on the CPU at a small size: a sound run is correct;
the control and every fault that the cell can have make it incorrect."""

import pytest
import torch

from benchmark import common
from benchmark.conftest import small_cell

CELLS = ["grasp.batch", "autodriving.batch", "grasp.stream"]


def run(name, **kw):
    cell = small_cell(name, **kw)
    out = common.load_module("traffic", cell.traffic).run(cell)
    return cell, out


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    cell, out = run(name)
    assert out["attempted"] > 0 and out["failed"] == 0
    assert common.judge(out["checks"], cell.limits), out["checks"]
    assert set(out["checks"]) == set(cell.limits)


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = small_cell(name)
    checks = common.load_module("traffic", cell.traffic).control(cell)
    assert not common.judge(checks, cell.limits), checks


def _half_batch(fn):
    """The second half of each batch left out: its rows repeat the first
    half's answers."""
    def broken(mem, prev, nxt, *args, **kw):
        h = (mem.shape[0] + 1) // 2
        out = fn(mem[:h], prev[:h], nxt[:h], *args, **kw)
        idx = torch.arange(mem.shape[0]) % h
        return {k: v[idx.to(v.device)] for k, v in out.items()}
    return broken


def _altered(fn):
    """Every answer altered where it is produced: one mask pixel flipped,
    the flow nudged, the box moved by a pixel."""
    def broken(*args, **kw):
        out = fn(*args, **kw)
        out["mask"] = out["mask"].clone()
        out["mask"][:, 0, 0] ^= 255
        out["box"] = out["box"] + 1
        if "flow" in out:
            out["flow"] = out["flow"] + 0.01
        return out
    return broken


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [_half_batch, _altered])
def test_fault_is_not_correct(name, fault, monkeypatch):
    from nsof_tpu_torch.pipelines import segmentation, stream

    broken = fault(segmentation.seg_batch_fast)
    monkeypatch.setattr(segmentation, "seg_batch_fast", broken)
    monkeypatch.setattr(stream, "seg_batch_fast", broken)
    cell, out = run(name)
    assert not common.judge(out["checks"], cell.limits), out["checks"]


def test_stream_state_unchanged_is_not_correct(monkeypatch):
    from nsof_tpu_torch.pipelines import stream

    real = stream.scan_device

    def unchanged(frames, sim, w0, keep_states=False):
        _, gray, states = real(frames, sim, w0, keep_states)
        return w0.clone(), gray, states

    monkeypatch.setattr(stream, "scan_device", unchanged)
    cell, out = run("grasp.stream")
    assert not common.judge(out["checks"], cell.limits), out["checks"]


def test_same_seed_same_inputs():
    from benchmark import inputs

    cell = small_cell("grasp.batch")
    a = inputs.pairs(2**40 + 3, cell.config, cell.params, 5, "cpu", salt=1)
    b = inputs.pairs(2**40 + 3, cell.config, cell.params, 5, "cpu", salt=1)
    c = inputs.pairs(2**40 + 4, cell.config, cell.params, 5, "cpu", salt=1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[1], c[1])
