"""Device-honest timing harness: the port's counterpart of
:mod:`nsof_tpu.utils.timing`.

The reference brackets every stage with ``time.time()`` (module-global lists,
optical_flow_seg.py:51-59) and, for GPU backends, ``torch.cuda.synchronize``
(ff_seg.py:95-107).  PyTorch returns before the card finishes, so
:func:`block_until_ready` synchronises every CUDA device that holds a tensor
of a result (where the JAX package calls ``jax.block_until_ready``) before a
clock is read.

:func:`span` names a layer of the port's main path in a profiler trace and
:func:`count` records the work a layer was given; each costs one flag read
when no profiler records.
"""

from __future__ import annotations

import collections
import contextlib
import pathlib
import time
from typing import Any, Callable

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

_NO_SPAN = contextlib.nullcontext()
COUNT_KEEP = 64  # entries kept a name: the newest
_COUNTS: dict[str, collections.deque] = {}


def span(name: str):
    """A named range of the host's work, for the profiler: while a
    ``torch.profiler`` records, a ``record_function(name)`` range, whose
    kernels the trace ties to it by correlation id; otherwise one shared
    no-op context.  The off check reads the profiler's Python flag and
    makes no C call.  A span never synchronises, allocates, records a CUDA
    event or touches a tensor.  Usage::

        with span("nsof.gate"):
            ...
    """
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


def count(name: str, **values) -> None:
    """The work a layer was given, for a reader of the trace: while a
    ``torch.profiler`` records, ``values`` appended as one entry under
    ``name`` to an in-memory record that keeps the newest
    :data:`COUNT_KEEP` entries a name; otherwise nothing.  The off check
    reads the profiler's Python flag, as :func:`span` does.  Values are host
    ints or device tensors kept by reference: a count never copies,
    reduces, synchronises or launches, so what lives on the device is read
    after the traced window (:func:`counted`).  Host counts that are always
    on stay in ``_build.COUNTS``.  Usage::

        count("nsof.flow", rows=b, px=h * w)
    """
    if _autograd_profiler._is_profiler_enabled:
        rec = _COUNTS.get(name)
        if rec is None:
            rec = _COUNTS[name] = collections.deque(maxlen=COUNT_KEEP)
        rec.append(values)


def counted(name: str) -> list[dict]:
    """The entries :func:`count` recorded under ``name``, oldest first."""
    return list(_COUNTS.get(name, ()))


def reset_counts() -> None:
    """Forget every recorded entry."""
    _COUNTS.clear()


def _cuda_devices(tree, found: set) -> set:
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            found.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, found)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, found)
    return found


def block_until_ready(tree):
    """Wait until the work producing every CUDA tensor of ``tree`` (a
    tensor, or a dict, list or tuple of them) is done; returns ``tree``."""
    for dev in _cuda_devices(tree, set()):
        torch.cuda.synchronize(dev)
    return tree


def time_fn(
    fn: Callable[..., Any],
    *args,
    warmup: int = 2,
    iters: int = 10,
    **kwargs,
) -> dict[str, float]:
    """Time ``fn(*args)`` with device sync; returns seconds statistics.

    Returns dict with mean/p50/min/max wall seconds per call.
    """
    for _ in range(warmup):
        block_until_ready(fn(*args, **kwargs))
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        block_until_ready(fn(*args, **kwargs))
        samples.append(time.perf_counter() - t0)
    s = np.asarray(samples)
    return {
        "mean_s": float(s.mean()),
        "p50_s": float(np.percentile(s, 50)),
        "min_s": float(s.min()),
        "max_s": float(s.max()),
        "iters": iters,
    }


class StageTimer:
    """Accumulates named stage timings (the CSV columns of the reference)."""

    def __init__(self):
        self.records: dict[str, list[float]] = {}

    def add(self, name: str, seconds: float) -> None:
        self.records.setdefault(name, []).append(seconds)

    def time(self, name: str):
        timer = self

        class _Ctx:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                timer.add(name, time.perf_counter() - self.t0)
                return False

        return _Ctx()

    def summary(self) -> dict[str, float]:
        return {k: float(np.mean(v)) for k, v in self.records.items()}


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Context manager capturing a ``torch.profiler`` trace of the host and,
    where there is one, the CUDA device, written as a Chrome trace to
    ``log_dir/trace.json`` (viewable in Perfetto or ``chrome://tracing``).
    Yields the profiler, whose ``key_averages()`` sums the time by kernel.

    The port's main path marks its layers with :func:`span`, so the trace
    holds these ranges, each kernel tied to the one that launched it:
    ``nsof.seg_batch_fast`` holds ``nsof.gate``, ``nsof.crop``,
    ``nsof.farneback`` (``nsof.farneback.pyramid``, ``.expand`` and
    ``.update`` a pyramid level), ``nsof.head`` and ``nsof.scatter``;
    ``nsof.stream_masks`` holds ``nsof.frame_sim.compress``,
    ``nsof.frame_sim.scan`` and then ``nsof.seg_batch_fast``;
    ``nsof.deep_roi_flow_batch`` holds ``nsof.gate``, ``nsof.crop``,
    ``nsof.deep.flow`` (the backend's ``nsof.raft.*`` or
    ``nsof.flowformer.*`` spans), ``nsof.head`` and ``nsof.scatter``;
    ``nsof.sam_gt_batch`` holds ``nsof.sam.preprocess``, ``nsof.sam.encode``
    (``.window`` and ``.global`` a block), ``nsof.sam.decode`` and
    ``nsof.sam.postprocess``.  While it records, :func:`count` keeps
    ``nsof.gate`` (each gate call's ``rows``, ``active``, ``box``, window
    origins ``oys``/``oxs`` and shape ``win``) and ``nsof.flow`` (the
    ``rows`` and ``px`` a row the flow computed), read by
    :func:`counted` once the window is over.

    Usage::

        with profile_trace("traces/seg"):
            block_until_ready(seg_batch_fast(mem, prev, nxt, cfg))
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))
