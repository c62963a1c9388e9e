"""A short profiled sub-window and what the per-layer readers take from it.

``torch.profiler`` (CUPTI on the card) records the device's operations and
the host's; :func:`traced` profiles a few calls inside a
``record_function`` span, writes the Chrome trace under the checkout and
reads it back into a :class:`Trace`:

- device operations (kernels, copies, fills) as intervals, clipped to the
  span: busy time is their union, idle time the rest of the span;
- each kernel's launch on the host, by the correlation id CUPTI gives
  both; with ``with_stack`` the Python frames around that launch, so that
  a kernel can be charged to the module of the port that launched it;
- the longest idle gaps, each named by what the host was doing then.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import pathlib

WINDOW = "benchmark.traced_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("python_function", "cpu_op", "user_annotation")
TOP = 10
NAMED_GAPS = 300  # the longest gaps named by the host's activity


class Trace:
    """The events of one traced span (``ts``/``dur`` in µs)."""

    def __init__(self, events: list[dict]):
        span = [e for e in events if e.get("cat") == "user_annotation"
                and e.get("name") == WINDOW and e.get("ph") == "X"]
        if not span:
            raise ValueError("the trace has no traced-window span")
        self.t0 = float(span[0]["ts"])
        self.t1 = self.t0 + float(span[0]["dur"])
        self.main_tid = span[0].get("tid")
        self.device = []  # (start, end, name, cat, correlation)
        self.launch = {}  # correlation -> (tid, ts)
        self.host = collections.defaultdict(list)  # tid -> [(start, end, name, cat)]
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat")
            ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
            if cat in DEVICE_CATS:
                s, t = max(ts, self.t0), min(ts + dur, self.t1)
                if t > s:
                    self.device.append((s, t, e.get("name", "?"), cat,
                                        e.get("args", {}).get("correlation")))
            elif cat in LAUNCH_CATS:
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    self.launch[corr] = (e.get("tid"), ts)
            elif cat in HOST_CATS and e.get("name") != WINDOW:
                self.host[e.get("tid")].append((ts, ts + dur, e.get("name", "?"), cat))
        for v in self.host.values():
            v.sort()
        self.device.sort()
        self.has_stacks = any(c == "python_function" for v in self.host.values()
                              for *_, c in v)

    @classmethod
    def from_file(cls, path: pathlib.Path) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_intervals(self) -> list[tuple[float, float]]:
        out = []
        for s, t, *_ in self.device:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t)
            else:
                out.append([s, t])
        return [tuple(x) for x in out]

    @property
    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy_intervals()) * 1e-6

    @property
    def kernels(self) -> list[tuple]:
        return [d for d in self.device if d[3] == "kernel"]

    def kernel_seconds(self, symbol: str) -> tuple[float, int]:
        """Device seconds and launches of the kernels whose name holds
        ``symbol``."""
        ks = [k for k in self.kernels if symbol in k[2]]
        return sum(k[1] - k[0] for k in ks) * 1e-6, len(ks)

    def _frames(self) -> dict:
        """correlation id → the names of the host frames around its launch."""
        queries = collections.defaultdict(list)
        for k in self.device:
            launch = self.launch.get(k[4])
            if launch is not None:
                queries[launch[0]].append((launch[1], k[4]))
        out = {}
        for tid, qs in queries.items():
            evs = [e for e in self.host.get(tid, ()) if e[3] == "python_function"]
            qs.sort()
            stack, i = [], 0
            for q, corr in qs:
                while i < len(evs) and evs[i][0] <= q:
                    while stack and stack[-1][1] < evs[i][0]:
                        stack.pop()
                    stack.append(evs[i])
                    i += 1
                while stack and stack[-1][1] < q:
                    stack.pop()
                out[corr] = [e[2] for e in stack if e[1] >= q]
        return out

    def module_seconds(self, patterns) -> float | None:
        """Device seconds of the operations launched with a host frame
        whose name holds one of ``patterns`` (a file path of the port, or
        ``file(line): function``); None when the trace has no Python
        frames."""
        if not self.has_stacks:
            return None
        frames = self._frames()
        total = 0.0
        for s, t, _, _, corr in self.device:
            if any(p in f for f in frames.get(corr, ()) for p in patterns):
                total += t - s
        return total * 1e-6

    def host_at(self, t: float) -> str:
        """The innermost host event around time ``t``: on the main thread,
        or where it has none (it sleeps while another thread works), on
        the thread whose innermost event started last."""
        best = None
        for tid in [self.main_tid] + [k for k in self.host if k != self.main_tid]:
            evs = self.host.get(tid, ())
            i = bisect.bisect_right(evs, (t, float("inf")))
            for e in reversed(evs[max(0, i - 4000) : i]):
                if e[1] >= t:  # the latest-starting event around t is the innermost
                    if best is None or e[0] > best[0]:
                        best = e
                    break
            if best is not None and tid == self.main_tid:
                break
        return "host idle or in an untraced call" if best is None else best[2][:120]

    def breakdown(self) -> dict:
        """The device operations that took most time and the longest idle
        gaps, summed by what the host was doing, [name, seconds] each."""
        ops = collections.Counter()
        for s, t, name, *_ in self.device:
            ops[name[:120]] += (t - s) * 1e-6
        spans = []
        prev = self.t0
        for s, t in self.busy_intervals() + [(self.t1, self.t1)]:
            if s > prev:
                spans.append((s - prev, (prev + s) / 2))
            prev = max(prev, t)
        spans.sort(reverse=True)
        gaps = collections.Counter()
        for i, (length, mid) in enumerate(spans):
            name = self.host_at(mid) if i < NAMED_GAPS else "shorter gaps, not named"
            gaps[name] += length * 1e-6
        return {"device_ops": [[n, v] for n, v in ops.most_common(TOP)],
                "idle_gaps": [[n, v] for n, v in gaps.most_common(TOP)]}


@contextlib.contextmanager
def traced(path: pathlib.Path, with_stack: bool):
    """Profile the body as one traced window; yields a list that holds the
    :class:`Trace` once the body has ended.  The body ends in a device
    synchronisation."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    path.parent.mkdir(parents=True, exist_ok=True)
    holder = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 with_stack=with_stack) as prof:
        with record_function(WINDOW):
            yield holder
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    holder.append(Trace.from_file(path))
