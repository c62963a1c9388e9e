"""The readers of the program's spans (``benchmark/spans.py`` and the
per-layer metrics built on it) on a hand-worked Chrome trace.

The window runs from 0 to 200 µs on thread 1.  Two steps: the first
(20–120) holds the gate (25–40), the Farnebäck (45–100) with its expansion
(50–70), and the scatter (105–115); the second (160–180) holds nothing
else.  Kernels are launched on thread 1 inside the gate, the expansion,
the Farnebäck's own code, the scatter, between the steps and in the second
step, and one on thread 2, which has no spans, while thread 1 is in the
expansion.  The device's first operation starts at 32 µs.
"""

import json
import types

import pytest

from benchmark import common, spans
from benchmark.run import Reading
from benchmark.trace import WINDOW, Trace

NEW = ("gate.device_ms_per_pair", "scatter.device_ms_per_pair",
       "farneback.expand.device_ms_per_pair", "step.idle_ms_per_pair",
       "step.syncs_per_call")
PAIRS = 4


def X(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
            "args": args}


def span(name, ts, dur):
    return X("user_annotation", name, ts, dur)


def launch(ts, corr, tid=1):
    return X("cuda_runtime", "cudaLaunchKernel", ts, 1, tid=tid, correlation=corr)


def kernel(name, ts, dur, corr):
    return X("kernel", name, ts, dur, tid=7, correlation=corr)


SPANS = [span("nsof.seg_batch_fast", 20, 100), span("nsof.gate", 25, 15),
         span("nsof.farneback", 45, 55), span("nsof.farneback.expand", 50, 20),
         span("nsof.scatter", 105, 10), span("nsof.seg_batch_fast", 160, 20)]
LAUNCHES = [launch(30, 1), launch(55, 2), launch(80, 3), launch(110, 4), launch(130, 5),
            launch(55, 6, tid=2), launch(165, 7)]
KERNELS = [kernel("gate_k", 32, 5, 1), kernel("expand_k", 57, 10, 2),
           kernel("fb_k", 82, 8, 3), kernel("scatter_k", 112, 4, 4),
           kernel("between_k", 140, 10, 5), kernel("other_thread_k", 70, 3, 6),
           kernel("step2_k", 170, 5, 7)]
SYNCS = [X("cuda_runtime", "cudaStreamSynchronize", 60, 2),  # in step 1: counted
         X("cuda_runtime", "cudaMemcpy", 101, 2),  # blocking copy in step 1: counted
         X("cuda_runtime", "cudaMemcpyAsync", 90, 1),  # does not wait
         X("cuda_runtime", "cudaStreamSynchronize", 125, 2),  # between the steps
         X("cuda_runtime", "cudaStreamSynchronize", 60, 2, tid=2)]  # another thread


def events(with_spans=True):
    return ([X("user_annotation", WINDOW, 0, 200)] + (SPANS if with_spans else [])
            + LAUNCHES + KERNELS + SYNCS)


def reading(tmp_path, evs):
    path = tmp_path / "grasp.batch.trace.json"
    path.write_text(json.dumps({"traceEvents": evs}))
    cell = types.SimpleNamespace(name="grasp.batch", scratch=tmp_path)
    return Reading(cell, Trace.from_file(path), PAIRS, {}, {})


def read_all(r):
    return {name: common.load_module("layer_metrics", name).read(r) for name in NEW}


def test_innermost_span_by_correlation_id(tmp_path):
    s = spans.of(reading(tmp_path, events()))
    paths = {op[2]: path for op, path in s.ops}
    assert paths["gate_k"] == ("nsof.seg_batch_fast", "nsof.gate")
    assert paths["expand_k"] == ("nsof.seg_batch_fast", "nsof.farneback",
                                 "nsof.farneback.expand")
    assert paths["fb_k"] == ("nsof.seg_batch_fast", "nsof.farneback")
    assert paths["step2_k"] == ("nsof.seg_batch_fast",)
    # launched between the steps, and on a thread with no spans
    assert paths["between_k"] == paths["other_thread_k"] == ()
    assert s.device_seconds("nsof.farneback") == pytest.approx(18e-6)
    assert s.device_seconds("nsof.seg_batch_fast") == pytest.approx(32e-6)
    assert s.steps == [(20.0, 120.0), (160.0, 180.0)]
    got = read_all(reading(tmp_path, events()))
    assert got["gate.device_ms_per_pair"] == pytest.approx(5e-3 / PAIRS)
    assert got["farneback.expand.device_ms_per_pair"] == pytest.approx(10e-3 / PAIRS)
    assert got["scatter.device_ms_per_pair"] == pytest.approx(4e-3 / PAIRS)


def test_idle_counts_from_the_first_device_operation(tmp_path):
    s = spans.of(reading(tmp_path, events()))
    # device gaps from 32 µs on: 37-57, 67-70, 73-82, 90-112, 116-140, 150-170,
    # 175-200; inside the steps 20-120 and 160-180:
    # 20 + 3 + 9 + 22 + 4 and 10 + 5 µs; the lead-in 20-32 is left out
    assert s.step_idle_seconds() == pytest.approx(73e-6)
    by_span = {}
    for lo, hi, path in s.idle():
        by_span[path[-1]] = by_span.get(path[-1], 0.0) + hi - lo
    assert by_span == pytest.approx({"nsof.gate": 3.0, "nsof.seg_batch_fast": 29.0,
                                     "nsof.farneback": 24.0,
                                     "nsof.farneback.expand": 10.0, "nsof.scatter": 7.0})
    got = read_all(reading(tmp_path, events()))
    assert got["step.idle_ms_per_pair"] == pytest.approx(73e-3 / PAIRS)


def test_syncs_only_inside_a_step_on_its_thread(tmp_path):
    got = read_all(reading(tmp_path, events()))
    assert got["step.syncs_per_call"] == pytest.approx(2 / 2)


def test_no_program_spans_reads_none(tmp_path):
    r = reading(tmp_path, events(with_spans=False))
    assert spans.of(r) is None
    assert read_all(r) == dict.fromkeys(NEW)
    r.trace = None
    assert read_all(r) == dict.fromkeys(NEW)


def test_table_self_and_inclusive(tmp_path, capsys):
    r = reading(tmp_path, events())
    rows = {row["span"]: row for row in spans.of(r).table(PAIRS)}
    fb = rows["nsof.farneback"]
    assert (fb["depth"], fb["calls"]) == (1, 1)
    assert fb["device_ms_incl"] * PAIRS == pytest.approx(18e-3)
    assert fb["device_ms_self"] * PAIRS == pytest.approx(8e-3)
    assert fb["launches_incl"] * PAIRS == pytest.approx(2)
    assert fb["host_ms_incl"] * PAIRS == pytest.approx(55e-3)
    assert fb["host_ms_self"] * PAIRS == pytest.approx(35e-3)
    assert fb["idle_ms_incl"] * PAIRS == pytest.approx(34e-3)
    step = rows["nsof.seg_batch_fast"]
    assert step["calls"] == 2 and step["idle_ms_incl"] * PAIRS == pytest.approx(73e-3)
    assert spans.main([str(spans.trace_path(r)), "--pairs", str(PAIRS)]) == 0
    out = capsys.readouterr().out
    assert "`nsof.farneback.expand`" in out and "syncs in steps 2" in out
