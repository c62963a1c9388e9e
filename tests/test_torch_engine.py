"""The port's ``BatchingEngine`` (``nsof_tpu_torch/serve/engine.py``) on the
CPU: ``tests/test_engine.py``'s checks of the JAX engine, ported.

On the tabletennis preset cut to 96×128 (memsize 16) with random frames
and state maps made with numpy from a seed: the bucket ladder; 12 requests
from 12 threads (the interpreter switching threads every 10 µs) each equal
to the direct ``seg_batch_fast`` of the stacked requests; coalescing (fewer
dispatches than requests); a malformed request failing its own future and
the engine serving after it; a malformed request merged into a batch with
well-formed ones failing that batch's futures only (the JAX engine's
collector thread dies there, ROADMAP queue 3); ``RuntimeError`` after
shutdown.  The default ``seg_batch_fast`` is held against the JAX package's
by ``tests/test_torch_segmentation.py``.
"""

import dataclasses
import sys
import threading
from concurrent.futures import Future

import numpy as np
import pytest

from nsof_tpu_torch.config import DATASETS
from nsof_tpu_torch.pipelines.segmentation import seg_batch_fast
from nsof_tpu_torch.serve.engine import BatchingEngine
from torch_single_thread import one_torch_thread  # noqa: F401  (autouse)

GH, GW = 96 // 16, 128 // 16
N = 12


def _cfg():
    cfg = dataclasses.replace(DATASETS["tabletennis"], image_h=96, image_w=128,
                              window_h=96, window_w=128)
    return dataclasses.replace(cfg, roi=dataclasses.replace(cfg.roi, memsize=16))


def _inputs(n=N, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, GH, GW)).astype(np.uint8),
            rng.integers(0, 256, (n, 96, 128)).astype(np.uint8),
            rng.integers(0, 256, (n, 96, 128)).astype(np.uint8))


def _bad():
    """A rank-1 frame: cannot be stacked or gated."""
    return (np.zeros((GH, GW), np.uint8), np.zeros((96,), np.uint8),
            np.zeros((96, 128), np.uint8))


@pytest.fixture(scope="module")
def engine():
    eng = BatchingEngine(_cfg(), max_batch=8, max_wait_ms=50, device="cpu")
    eng.warmup()
    yield eng
    eng.shutdown()


def _direct(mems, prevs, nxts):
    ref = seg_batch_fast(mems, prevs, nxts, _cfg(), device="cpu")
    return {k: v.numpy() for k, v in ref.items()}


def test_bucket_ladder():
    eng = BatchingEngine(_cfg(), max_batch=8, device="cpu")
    try:
        assert eng.buckets == (1, 2, 4, 8)
        assert [eng._bucket_for(n) for n in (1, 3, 5, 8)] == [1, 4, 8, 8]
        with pytest.raises(ValueError, match="max_batch"):
            BatchingEngine(_cfg(), max_batch=8, buckets=(1, 4), device="cpu")
    finally:
        eng.shutdown()


def test_concurrent_parity_and_coalescing(engine):
    mems, prevs, nxts = _inputs()
    before = engine.stats.as_dict()
    futs = [None] * N

    def worker(i):
        futs[i] = engine.submit(mems[i], prevs[i], nxts[i])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(N)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        results = [f.result(timeout=300) for f in futs]
    finally:
        sys.setswitchinterval(interval)
    ref = _direct(mems, prevs, nxts)
    for i, r in enumerate(results):
        assert set(r) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(r[k], ref[k][i], err_msg=f"req {i} key {k}")
    s = engine.stats.as_dict()
    requests = s["requests"] - before["requests"]
    dispatches = s["dispatches"] - before["dispatches"]
    assert requests == N
    assert dispatches < N, s
    assert requests / dispatches > 1.5, s


def test_error_isolation_and_recovery(engine):
    mems, prevs, nxts = _inputs(1, seed=3)
    with pytest.raises(Exception):
        engine.submit(*_bad()).result(timeout=300)
    ok = engine.submit(mems[0], prevs[0], nxts[0]).result(timeout=300)
    np.testing.assert_array_equal(ok["mask"], _direct(mems, prevs, nxts)["mask"][0])


def test_malformed_request_merged_with_good_ones(engine):
    """A batch of three well-formed requests and a malformed one: its
    stacking fails inside the dispatch's error handling, so the batch's four
    futures fail, and the collector lives on and serves the next request."""
    mems, prevs, nxts = _inputs(3, seed=5)
    batch = [(mems[i], prevs[i], nxts[i], Future()) for i in range(3)]
    batch.append((*_bad(), Future()))
    engine._dispatch(batch)
    for item in batch:
        assert isinstance(item[3].exception(timeout=0), ValueError)
    queued = [engine.submit(mems[i], prevs[i], nxts[i]) for i in range(3)]
    queued.append(engine.submit(*_bad()))
    with pytest.raises(ValueError):
        queued[-1].result(timeout=300)
    for f in queued[:-1]:
        f.exception(timeout=300)  # resolved, whichever batch it joined
    assert engine._thread.is_alive()
    ok = engine.submit(mems[1], prevs[1], nxts[1]).result(timeout=300)
    np.testing.assert_array_equal(ok["mask"], _direct(mems, prevs, nxts)["mask"][1])


def test_runtime_error_after_shutdown():
    mems, prevs, nxts = _inputs(1)
    eng = BatchingEngine(_cfg(), max_batch=2, device="cpu")
    fut = eng.submit(mems[0], prevs[0], nxts[0])
    eng.shutdown()
    assert not eng._thread.is_alive()
    assert fut.done()
    with pytest.raises(RuntimeError):
        eng.submit(mems[0], prevs[0], nxts[0])
