"""The program's own spans in a traced window, and what the per-layer
readers take from them.

The port marks the layers of its main path with ``record_function``
ranges named ``nsof.*`` (``nsof_tpu_torch/utils/timing.py::span``); they
land in the same Kineto trace as the device's operations, on the same
clock.  :class:`Spans` charges each device operation of a
:class:`benchmark.trace.Trace` to the innermost program span that holds its
launch on the launching thread (the launch is found by the correlation id
CUPTI gives both), and each idle stretch of the device to the spans the
main thread was in at the time.  A step is an outermost program span on
the main thread: ``nsof.seg_batch_fast`` in the batch cells,
``nsof.stream_masks`` in the stream cell.

    python -m benchmark.spans <trace.json> --pairs <n>

prints a table of every span's device, launch, host and idle time a pair,
self and inclusive, from a trace a traced run wrote
(``build/benchmark/<cell>.trace.json``).
"""

from __future__ import annotations

import argparse
import bisect
import collections
import functools
import json
import pathlib

PREFIX = "nsof."
# the CUDA runtime calls that make the host wait for the device
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")


def segments(spans) -> list[tuple[float, float, tuple]]:
    """Properly nested ``(start, end, name)`` spans of one thread → the
    timeline cut where any span starts or ends, ``(start, end, path)``
    each, ``path`` the names of the spans that hold it, outermost first;
    stretches in no span are left out."""
    out, stack, t = [], [], float("-inf")

    def emit(until):
        nonlocal t
        if stack and until > t:
            out.append((t, until, tuple(x[2] for x in stack)))
        t = max(t, until)

    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][1] <= s:
            emit(stack[-1][1])
            stack.pop()
        emit(s)
        stack.append((s, e, name))
    while stack:
        emit(stack[-1][1])
        stack.pop()
    return out


def _overlap(a: list, b: list) -> list[tuple[float, float, tuple]]:
    """The parts of ``b``'s ``(start, end, path)`` segments that lie in
    ``a``'s ``(start, end)`` intervals; both sorted, each disjoint."""
    out, i = [], 0
    for s, e, path in b:
        while i < len(a) and a[i][1] <= s:
            i += 1
        j = i
        while j < len(a) and a[j][0] < e:
            lo, hi = max(s, a[j][0]), min(e, a[j][1])
            if hi > lo:
                out.append((lo, hi, path))
            j += 1
    return out


class Spans:
    """The ``nsof.*`` spans of one :class:`benchmark.trace.Trace`."""

    def __init__(self, trace):
        self.trace = trace
        self.spans = {}  # tid -> [(start, end, name)], sorted
        for tid, evs in trace.host.items():
            mine = [(s, e, n) for s, e, n, c in evs
                    if c == "user_annotation" and n.startswith(PREFIX)]
            if mine:
                self.spans[tid] = sorted(mine, key=lambda x: (x[0], -x[1]))
        self.by_tid = {tid: segments(v) for tid, v in self.spans.items()}
        self.steps = []  # (start, end) of each outermost span on the main thread
        for s, e, _ in self.spans.get(trace.main_tid, []):
            if not self.steps or s >= self.steps[-1][1]:
                self.steps.append((s, e))
        self._starts = {tid: [x[0] for x in seg] for tid, seg in self.by_tid.items()}
        # each device operation with the path of the span around its launch
        self.ops = [(op, self.path_at(*trace.launch.get(op[4], (None, None))))
                    for op in trace.device]

    def __bool__(self) -> bool:
        return bool(self.by_tid)

    def path_at(self, tid, ts) -> tuple:
        """The spans that hold time ``ts`` on thread ``tid``, outermost
        first (empty: none, or no such launch)."""
        if ts is None or tid not in self.by_tid:
            return ()
        seg = self.by_tid[tid]
        i = bisect.bisect_right(self._starts[tid], ts) - 1
        return seg[i][2] if i >= 0 and ts < seg[i][1] else ()

    def device_seconds(self, name: str) -> float:
        """Device seconds of the operations launched inside ``name``."""
        return sum(op[1] - op[0] for op, path in self.ops if name in path) * 1e-6

    def idle(self) -> list[tuple[float, float, tuple]]:
        """The device's idle stretches from the window's first device
        operation to its end, cut by the main thread's spans:
        ``(start, end, path)``, each within some span."""
        if not self.trace.device:
            return []
        gaps, prev = [], self.trace.device[0][0]
        for s, t in self.trace.busy_intervals() + [(self.trace.t1, self.trace.t1)]:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, t)
        return _overlap(gaps, self.by_tid.get(self.trace.main_tid, []))

    def step_idle_seconds(self) -> float:
        return sum(e - s for s, e, _ in self.idle()) * 1e-6

    def table(self, pairs: int) -> list[dict]:
        """Every span name's calls and its device ms, launches, host ms
        and idle ms a pair, self and inclusive, in order of first call."""
        rows = {}

        def row(path):
            name = path[-1]
            if name not in rows:
                rows[name] = dict(span=name, depth=len(path) - 1, calls=0,
                                  **{f"{k}_{w}": 0.0 for k in ("device_ms", "launches",
                                                               "host_ms", "idle_ms")
                                     for w in ("self", "incl")})
            return rows[name]

        def add(path, key, v):
            for i, name in enumerate(path):
                row(path[: i + 1])[f"{key}_incl"] += v
            if path:
                row(path)[f"{key}_self"] += v

        for tid, segs in self.by_tid.items():
            for s, e, path in segs:
                add(path, "host_ms", (e - s) * 1e-3)
        for v in self.spans.values():
            for _, _, name in v:
                rows[name]["calls"] += 1
        for op, path in self.ops:
            add(path, "device_ms", (op[1] - op[0]) * 1e-3)
            if op[3] == "kernel":
                add(path, "launches", 1.0)
        for s, e, path in self.idle():
            add(path, "idle_ms", (e - s) * 1e-3)
        for r in rows.values():
            for k in r:
                if k.endswith(("_self", "_incl")):
                    r[k] /= pairs
        return list(rows.values())


@functools.lru_cache(maxsize=1)
def _spans(trace) -> Spans:
    return Spans(trace)


def of(reading) -> Spans | None:
    """The program's spans of a reading's trace; None without a trace, a
    pair, or any program span (a program that records none)."""
    if reading.trace is None or not reading.traced_pairs:
        return None
    spans = _spans(reading.trace)
    return spans if spans else None


def device_ms_per_pair(reading, name: str) -> float | None:
    spans = of(reading)
    return None if spans is None else spans.device_seconds(name) * 1e3 / reading.traced_pairs


def syncs(path: pathlib.Path, spans: Spans) -> int:
    """The :data:`SYNC_CALLS` in the Chrome trace at ``path`` made on the
    main thread inside a step span."""
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    steps = spans.steps
    starts = [s for s, _ in steps]
    n = 0
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") == "cuda_runtime"
                and e.get("name") in SYNC_CALLS and e.get("tid") == spans.trace.main_tid):
            ts = float(e.get("ts", 0.0))
            i = bisect.bisect_right(starts, ts) - 1
            n += i >= 0 and ts < steps[i][1]
    return n


def trace_path(reading) -> pathlib.Path:
    return reading.cell.scratch / f"{reading.cell.name}.trace.json"


def main(argv=None) -> int:
    from benchmark.trace import Trace

    ap = argparse.ArgumentParser(description="Per-span table of a traced run's trace.")
    ap.add_argument("trace", type=pathlib.Path)
    ap.add_argument("--pairs", type=int, required=True, help="the pairs the trace covers")
    args = ap.parse_args(argv)
    spans = Spans(Trace.from_file(args.trace))
    if not spans:
        print("no program spans in the trace")
        return 1
    cols = ("device_ms", "launches", "host_ms", "idle_ms")
    print("| span | calls | " + " | ".join(f"{c} self | {c} incl" for c in cols) + " |")
    print("|---" * (2 + 2 * len(cols)) + "|")
    for r in spans.table(args.pairs):
        vals = " | ".join(f"{r[f'{c}_self']:.4f} | {r[f'{c}_incl']:.4f}" for c in cols)
        print(f"| {'  ' * r['depth']}`{r['span']}` | {r['calls']} | {vals} |")
    print(f"steps {len(spans.steps)}; syncs in steps {syncs(args.trace, spans)}; "
          f"step idle ms a pair {spans.step_idle_seconds() * 1e3 / args.pairs:.4f}")
    counts = collections.Counter(path[-1] if path else "(no span)" for _, path in spans.ops)
    print("device operations by innermost span:", dict(counts))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
