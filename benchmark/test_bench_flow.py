"""The ``flow.*`` readers (``benchmark/counts.py`` and
``benchmark/layer_metrics/flow.*.py``) on ``test_bench_spans.py``'s
hand-worked trace, whose ``nsof.farneback`` span holds 18 µs of device
time over 4 pairs, and a record made under the profiler.

The record: two gate calls of 4 rows in 20×20 windows, 3 and 2 rows active,
and two flow calls of 4 rows of 400 px.  The first gate call's boxes
(x0, y0, x1, y1) against their window origins (oy, ox): a 10×10 box inside
its window, inactive; a 20×10 box whose window starts at (5, 10), so 10
columns and 10 rows fall inside; a box past its window's right and bottom
edges, 5 × 5 inside; a 1×1 box.  The second's: a 20×20 box filling its
window, a 4×3 box, and two inactive rows.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import common, counts
from benchmark.test_bench_spans import PAIRS, events, reading
from nsof_tpu_torch.utils import timing

NEW = ("flow.useful_pair_share", "flow.useful_px_share", "flow.discarded_ms_per_pair")
T = torch.tensor
GATE = [dict(rows=4, active=T([False, True, True, True]),
             box=T([[0, 0, 10, 10], [0, 5, 20, 15], [15, 15, 40, 40], [3, 3, 4, 4]]),
             oys=T([0, 5, 0, 0], dtype=torch.int32), oxs=T([0, 10, 0, 0], dtype=torch.int32),
             win=(20, 20)),
        dict(rows=4, active=T([True, True, False, False]),
             box=T([[0, 0, 20, 20], [2, 2, 6, 5], [0, 0, 20, 20], [0, 0, 20, 20]]),
             oys=T([0, 0, 0, 0]), oxs=T([0, 0, 0, 0]), win=(20, 20))]
KEPT = [10 * 10 + 5 * 5 + 1, 400 + 4 * 3]


@pytest.fixture
def recorded():
    timing.reset_counts()
    with profile(activities=[ProfilerActivity.CPU]):
        for g in GATE:
            timing.count("nsof.gate", **g)
            timing.count("nsof.flow", rows=4, px=400)
    yield
    timing.reset_counts()


def read_all(r):
    return {name: common.load_module("layer_metrics", name).read(r) for name in NEW}


def test_kept_px_from_coordinates():
    assert [counts.kept_px(g) for g in GATE] == KEPT


def test_the_three_readings(tmp_path, recorded):
    got = read_all(reading(tmp_path, events()))
    assert got["flow.useful_pair_share"] == pytest.approx(100 * 5 / 8)
    assert got["flow.useful_px_share"] == pytest.approx(100 * sum(KEPT) / 3200)
    assert got["flow.discarded_ms_per_pair"] == pytest.approx(18e-3 / PAIRS * 3 / 8)


def test_none_without_a_trace_or_a_record(tmp_path, recorded):
    r = reading(tmp_path, events())
    r.trace = None
    assert read_all(r) == dict.fromkeys(NEW)
    timing.reset_counts()
    assert read_all(reading(tmp_path, events())) == dict.fromkeys(NEW)


def test_none_from_a_program_without_counters(tmp_path, recorded, monkeypatch):
    monkeypatch.delattr(timing, "counted")
    assert read_all(reading(tmp_path, events())) == dict.fromkeys(NEW)


def test_discarded_reads_none_without_program_spans(tmp_path, recorded):
    got = read_all(reading(tmp_path, events(with_spans=False)))
    assert got["flow.discarded_ms_per_pair"] is None
    assert got["flow.useful_pair_share"] == pytest.approx(62.5)
