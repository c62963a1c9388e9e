"""Dynamic-batching serving engine for the ROI-gated segmentation path: the
port's counterpart of :mod:`nsof_tpu.serve.engine`.

Concurrent callers submit single frame pairs; a collector thread coalesces
them into ONE ``seg_batch_fast`` call on the device (kernels K1–K4), or with
:meth:`BatchingEngine.for_deep_backend` one ``deep_roi_flow_batch`` call
(RAFT or FlowFormer on RGB windows cropped by K1), so the
card sees large batches and the fixed cost of a call (launches, the host's
copies, one synchronisation) is amortized across requests instead of paid
per frame.

* **Bucketed padding.**  A batch is padded up to the next size in
  ``buckets`` by repeating its last request, whose results are dropped, so
  the device sees a few batch sizes, each built and warmed ahead of time by
  :meth:`BatchingEngine.warmup`.
* **max_wait batching window.**  The collector takes whatever is queued,
  then waits at most ``max_wait_ms`` for stragglers while the batch is
  below ``max_batch`` — the standard latency/throughput knob.
* **One dispatch thread.**  All device work happens on the collector
  thread; callers only block on per-request futures.  A dispatch stacks the
  requests into pinned host memory, uploads each input with one
  asynchronous copy, runs the batch and brings each output to the host with
  one asynchronous copy, then synchronises once.

A request that cannot be stacked with the others (a wrong shape) fails the
futures of its own batch only, and the engine keeps serving.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np
import torch

from nsof_tpu_torch import _build
from nsof_tpu_torch.config import PipelineConfig


@dataclass
class EngineStats:
    requests: int = 0
    dispatches: int = 0
    padded_lanes: int = 0
    batch_sizes: list = field(default_factory=list)

    def as_dict(self) -> dict:
        n = max(self.dispatches, 1)
        return {
            "requests": self.requests,
            "dispatches": self.dispatches,
            "mean_batch": self.requests / n,
            "padded_lanes": self.padded_lanes,
            "max_batch_seen": max(self.batch_sizes, default=0),
        }


class BatchingEngine:
    """Coalesce concurrent seg requests into batched device calls.

    Usage::

        eng = BatchingEngine(cfg, max_batch=128, max_wait_ms=4)
        eng.warmup()                       # build and run every bucket
        fut = eng.submit(mem_u8, prev_gray, next_gray)
        result = fut.result()              # {"mask", "box", "any_active",
                                           #  "region_pct"} numpy, one item
        eng.shutdown()
    """

    def __init__(
        self,
        cfg: PipelineConfig,
        max_batch: int = 128,
        max_wait_ms: float = 4.0,
        buckets: tuple[int, ...] | None = None,
        warp_radius: int | None = None,
        run_fn=None,
        frame_channels: int = 0,
        device=None,
        kernel_mode: str = "auto",
        mem_grid: tuple[int, int] | None = None,
    ):
        """``run_fn(mems [B,gh,gw], prevs, nxts) -> dict of [B,...]``, on
        tensors on ``device``, overrides the default ``seg_batch_fast`` path
        (``warp_radius``, ``kernel_mode``).  ``frame_channels`` declares the
        submitted frame rank (0 = gray [H, W], 3 = RGB [H, W, 3]) and
        ``mem_grid`` the state maps' (gh, gw) (default the image over
        ``cfg.roi.memsize``), so :meth:`warmup` builds the right dummies.
        Runs on ``device`` (default the CUDA device; raises ``RuntimeError``
        without one unless ``device='cpu'``)."""
        self.device = _build.resolve_device(device)
        self.cfg = cfg
        self.mem_grid = tuple(mem_grid) if mem_grid is not None else (
            cfg.image_h // cfg.roi.memsize, cfg.image_w // cfg.roi.memsize)
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        if buckets is None:
            buckets, b = [], 1
            while b < self.max_batch:
                buckets.append(b)
                b *= 2
            buckets.append(self.max_batch)
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        if self.buckets[-1] != self.max_batch:
            raise ValueError("largest bucket must equal max_batch")
        self.warp_radius = warp_radius
        self.kernel_mode = kernel_mode
        self.frame_channels = int(frame_channels)
        self.stats = EngineStats()
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()

        if run_fn is not None:
            self._run = run_fn
        else:
            from nsof_tpu_torch.pipelines.segmentation import seg_batch_fast

            def run(m, p, n):
                return seg_batch_fast(m, p, n, self.cfg, self.warp_radius, self.kernel_mode,
                                      device=self.device)

            self._run = run
        self._thread = threading.Thread(
            target=self._collector, name="nsof-batcher", daemon=True
        )
        self._thread.start()

    @classmethod
    def for_deep_backend(
        cls,
        cfg: PipelineConfig,
        backend,
        max_batch: int = 32,
        max_wait_ms: float = 8.0,
        buckets: tuple[int, ...] | None = None,
    ) -> "BatchingEngine":
        """Serving engine over the deep ROI-gated step
        (:func:`nsof_tpu_torch.pipelines.deep_flow.deep_roi_flow_batch`):
        submit ``(mem_u8 [gh, gw], prev_rgb [H, W, 3], next_rgb)`` per
        request; the collector coalesces them into one RAFT or FlowFormer
        batch on the backend's device.  The state maps are on the deep
        pipelines' grid, MEMSIZE/3 (raft_seg.py:460-464)."""
        from nsof_tpu_torch.pipelines.deep_flow import deep_roi_flow_batch

        ms_deep = max(cfg.roi.memsize // 3, 1)
        return cls(
            cfg, max_batch=max_batch, max_wait_ms=max_wait_ms, buckets=buckets,
            run_fn=lambda m, p, n: deep_roi_flow_batch(m, p, n, cfg, backend),
            frame_channels=3, device=backend.device,
            mem_grid=(cfg.image_h // ms_deep, cfg.image_w // ms_deep),
        )

    # -- public API -----------------------------------------------------
    def submit(
        self, mem_u8: np.ndarray, prev_gray: np.ndarray, next_gray: np.ndarray
    ) -> Future:
        """Enqueue one frame pair; returns a Future of per-item results."""
        if self._stop.is_set():
            raise RuntimeError("engine is shut down")
        fut: Future = Future()
        self._q.put((np.asarray(mem_u8), np.asarray(prev_gray),
                     np.asarray(next_gray), fut))
        return fut

    def warmup(self) -> None:
        """Run every bucket once through the dispatch path (stack, upload,
        run, download), which builds or loads the kernels and grows the
        device's caching allocator before traffic arrives.

        Call before serving traffic — warmup dispatches directly from
        the calling thread (deterministic bucket coverage, which queued
        dummy requests could not guarantee under collector timing).  Every
        cell of the state maps is at 255, so every row is active and a
        step that runs its flow on the active rows only (the deep ROI
        step) runs it on every bucket's full batch."""
        h, w = self.cfg.image_h, self.cfg.image_w
        gh, gw = self.mem_grid
        fshape = (h, w) if not self.frame_channels else (
            h, w, self.frame_channels
        )
        for b in self.buckets:
            self._execute([np.full((gh, gw), 255, np.uint8)] * b,
                          [np.zeros(fshape, np.uint8)] * b,
                          [np.zeros(fshape, np.uint8)] * b)

    def shutdown(self, wait: bool = True) -> None:
        self._stop.set()
        self._q.put(None)  # unblock the collector
        if wait:
            self._thread.join(timeout=60)
            # A submit() that passed the _stop check concurrently with this
            # shutdown may have enqueued its item after the collector's own
            # drain loop emptied the queue; drain once more so no caller
            # blocks forever on an unresolved future.
            self._drain_failing()

    def _drain_failing(self) -> None:
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                try:
                    item[3].set_exception(RuntimeError("engine shut down"))
                except Exception:
                    pass  # already resolved

    # -- collector ------------------------------------------------------
    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _collector(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.25)
            except queue.Empty:
                continue
            if first is None:
                break
            batch = [first]
            deadline = time.monotonic() + self.max_wait_s
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                try:
                    if remaining <= 0:
                        item = self._q.get_nowait()
                    else:
                        item = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if item is None:
                    self._stop.set()
                    break
                batch.append(item)
            self._dispatch(batch)
        # drain: fail any stragglers
        self._drain_failing()

    def _upload(self, arrays: list) -> torch.Tensor:
        """Stack ``arrays`` into one host tensor (pinned where the device is
        a CUDA one) and start its copy to the device."""
        cuda = self.device.type == "cuda"
        dtype = torch.from_numpy(np.empty(0, arrays[0].dtype)).dtype
        host = torch.empty((len(arrays),) + arrays[0].shape, dtype=dtype, pin_memory=cuda)
        np.stack(arrays, out=host.numpy())
        return host.to(self.device, non_blocking=cuda)

    def _execute(self, mems: list, prevs: list, nxts: list) -> dict:
        """One device call on the stacked requests → each output key as one
        host numpy array (one synchronisation)."""
        out = self._run(self._upload(mems), self._upload(prevs), self._upload(nxts))
        if self.device.type != "cuda":
            return {k: v.numpy() for k, v in out.items()}
        host = {k: v.to("cpu", non_blocking=True) for k, v in out.items()}
        torch.cuda.current_stream(self.device).synchronize()
        return {k: v.numpy() for k, v in host.items()}

    def _dispatch(self, batch) -> None:
        n = len(batch)
        b = self._bucket_for(n)
        pad = [batch[-1]] * (b - n)
        try:
            out = self._execute(*([x[j] for x in batch + pad] for j in range(3)))
        except Exception as e:  # surface to every caller in the batch
            for item in batch:
                item[3].set_exception(e)
            return
        self.stats.requests += n
        self.stats.dispatches += 1
        self.stats.padded_lanes += b - n
        self.stats.batch_sizes.append(n)
        if len(self.stats.batch_sizes) > 10_000:  # bounded history
            del self.stats.batch_sizes[:5_000]
        for i, item in enumerate(batch):
            item[3].set_result({k: v[i] for k, v in out.items()})
