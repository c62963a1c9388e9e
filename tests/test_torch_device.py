"""The port's device layer against the JAX package's.

Inputs are made with numpy from a seed and handed to both packages.

- The model functions against the JAX functions run op by op: modulation,
  the |Δ| transfer, the linear map and the gray map equal bit for bit;
  ``dwdt``, ``update_state``, ``resistance_exp`` and
  ``state_from_resistance`` within a few float32 ulps (PyTorch's ``pow``
  and ``exp`` on the CPU are not XLA's: measured ≤ 1 ulp, 2.0e-7 relative
  at most; held to 4e-7 relative, 1.2e-7 absolute for the state).
- ``compress_frames`` against ``jax.image.resize`` (lanczos3, antialias)
  through the JAX function: max |Δ| 4.8e-7 measured on frames in [0, 1],
  held to 2e-6 (the two float32 matrix products sum in another order).
- K8's plain version (the eager scan) against the jitted
  ``_scan_device_maps`` at n_substeps 1000 on ``tests/test_stream.py``'s
  8×8 grid (13 pairs): ``w_final`` within 2e-6, ``mem_gray`` within one
  level everywhere and equal at ≥ 99 % of cells (XLA fuses products into
  adds under jit, which can move the state by a few ulps over 13,000
  steps).  Measured on the CPU: ``w_final`` within 6.0e-8, ``mem_gray`` equal.
- ``simulate_frames``/``simulate_frames_fast`` against the jitted JAX ones,
  the same limits.
- The event simulator, V1 and V2 (split and magnitude), one-shot, resumed
  from a carry and chunked (``simulate_events_stream``), against
  ``simulate_events``: ``w_final`` within 1e-6 and every snapshot within
  2e-6 relative (measured: ``w_final`` equal, snapshots within 6e-8
  relative).
- The native binner against the numpy binner, and both against the JAX
  package's numpy ``bin_events``, with and without a window anchor and
  count: equal.
- ``generate_synthetic_events`` equal; the npz and metadata writers give
  the same files' contents.
"""

import dataclasses
import gzip
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsof_tpu.device import event_sim as jev
from nsof_tpu.device import frame_sim as jfs
from nsof_tpu.device import io as jio
from nsof_tpu.device import model as jm
from nsof_tpu.device import synthetic as jsyn
from nsof_tpu.pipelines.stream import _scan_device_maps as j_scan
from nsof_tpu_torch import native
from nsof_tpu_torch.device import event_sim as tev
from nsof_tpu_torch.device import frame_sim as tfs
from nsof_tpu_torch.device import io as tio
from nsof_tpu_torch.device import model as tm
from nsof_tpu_torch.device import synthetic as tsyn

H = W = 160
BIN_KEYS = ("counts", "on_any", "off_any", "any_ev", "t_first", "t_last", "valid")


def _np(x):
    return np.array(x)


@pytest.fixture(scope="module")
def model_inputs():
    rng = np.random.default_rng(0)
    w = rng.random((48, 64)).astype(np.float32)
    v = (rng.normal(size=(48, 64)) * 3).astype(np.float32)
    v[0, :8] = [0.0, -0.0, -0.2, 0.1, -0.19999, 0.10001, 12.9, -9.0]
    a = (rng.random((48, 64)) * 256).astype(np.float32)
    b = (rng.random((48, 64)) * 256).astype(np.float32)
    b[0, :4] = a[0, :4] + np.float32(0.7)
    return w, v, a, b


def test_model_exact_functions(model_inputs):
    w, v, a, b = model_inputs
    np.testing.assert_array_equal(tm.modulate_voltage(v).numpy(), _np(jm.modulate_voltage(v)))
    np.testing.assert_array_equal(tm.modulate_voltage(v, 0.5, 0.1, 2.0, -1.0).numpy(),
                                  _np(jm.modulate_voltage(v, 0.5, 0.1, 2.0, -1.0)))
    np.testing.assert_array_equal(tm.difference_voltage(a, b, 0.7, 1.5).numpy(),
                                  _np(jm.difference_voltage(a, b, 0.7, 1.5)))
    np.testing.assert_array_equal(tm.resistance_linear(w).numpy(), _np(jm.resistance_linear(w)))
    g = 1.0 / _np(jm.resistance_exp(w))
    g[0, :3] = [0.0, -1e-6, 1.0]
    np.testing.assert_array_equal(tm.conductance_to_gray(g).numpy(),
                                  _np(jm.conductance_to_gray(g)))


def test_model_rounded_functions(model_inputs):
    w, v, *_ = model_inputs
    for p in (tm.DEFAULT_PARAMS, dataclasses.replace(tm.DEFAULT_PARAMS, alpha_off=2.0,
                                                     alpha_on=1.5)):
        jp = jm.DeviceParams(**dataclasses.asdict(p))
        np.testing.assert_allclose(tm.dwdt(w, v, p).numpy(), _np(jm.dwdt(w, v, jp)),
                                   rtol=4e-7, atol=0)
        np.testing.assert_allclose(tm.update_state(w, v, p, 1e-3).numpy(),
                                   _np(jm.update_state(w, v, jp, 1e-3)), rtol=0, atol=1.2e-7)
    r = _np(jm.resistance_exp(w))
    np.testing.assert_allclose(tm.resistance_exp(w).numpy(), r, rtol=4e-7, atol=0)
    np.testing.assert_allclose(tm.state_from_resistance(r).numpy(),
                               _np(jm.state_from_resistance(r)), rtol=0, atol=1.2e-7)


def test_conductance_to_gray_float64():
    """Float64 in stays float64 (the formula in numpy's float64)."""
    g = np.geomspace(1e-8, 1e-4, 1000)
    ref = np.clip(-3366.0 / np.log10(g) - 306.0, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(tm.conductance_to_gray(torch.from_numpy(g)).numpy(), ref)


@pytest.mark.parametrize("m,n,region", [(20, 20, None), (20, 40, ((3, 5), (100, 150))),
                                        (7, 1, None)])
def test_compress_frames_matches_jax(m, n, region):
    rng = np.random.default_rng(m + n)
    frames = rng.random((5, 120, 160)).astype(np.float32)
    kw = {} if region is None else {"region_ul": region[0], "region_lr": region[1]}
    ref = _np(jfs.compress_frames(jnp.asarray(frames), m, n, **kw))
    got = tfs.compress_frames(frames, m, n, **kw, device="cpu").numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)


def _moving_box_frames(t=14):
    """tests/test_stream.py's stream: a bright box sweeping right."""
    frames = np.full((t, H, W), 20, np.uint8)
    for i in range(t):
        frames[i, 60:100, 8 + 3 * i : 48 + 3 * i] = 220
    return frames


@pytest.fixture(scope="module")
def scans():
    sim_j = jfs.FrameSimConfig(m=20, n=20)
    sim_t = tfs.FrameSimConfig(m=20, n=20)
    comp = _np(jfs.compress_frames(jnp.asarray(_moving_box_frames(), jnp.float32) / 255.0,
                                   20, 20))
    w0 = np.full(comp.shape[1:], 0.5, np.float32)
    ref = [_np(a) for a in jax.jit(j_scan, static_argnums=1)(comp, sim_j, w0)]
    got = [a.numpy() for a in tfs.scan_device(torch.from_numpy(comp), sim_t,
                                              torch.from_numpy(w0))[:2]]
    return comp, ref, got


def _assert_maps_close(got_w, ref_w, got_gray, ref_gray):
    np.testing.assert_allclose(got_w, ref_w, rtol=0, atol=2e-6)
    d = np.abs(got_gray.astype(int) - ref_gray.astype(int))
    assert d.max() <= 1, d.max()
    assert (d == 0).mean() >= 0.99, (d == 0).mean()


def test_plain_scan_matches_jitted_jax(scans):
    _, (ref_w, ref_gray), (got_w, got_gray) = scans
    assert got_gray.dtype == np.uint8 and got_gray.shape == ref_gray.shape == (13, 8, 8)
    _assert_maps_close(got_w, ref_w, got_gray, ref_gray)
    assert got_gray[-1, 3:5, 1:4].min() > got_gray[-1, 0, 7] + 5


def test_plain_scan_keeps_states(scans):
    """``keep_states`` gives the state after each pair, the last one
    ``w_final``; a split scan continued from the carry is the whole scan."""
    comp, _, (got_w, got_gray) = scans
    sim = tfs.FrameSimConfig(m=20, n=20)
    c = torch.from_numpy(comp)
    w_final, gray, states = tfs.scan_device(c[:6], sim, torch.full((8, 8), 0.5),
                                            keep_states=True)
    assert states.shape == (5, 8, 8) and torch.equal(states[-1], w_final)
    np.testing.assert_array_equal(gray.numpy(), got_gray[:5])
    w2, gray2, _ = tfs.scan_device(c[5:], sim, w_final)
    np.testing.assert_array_equal(w2.numpy(), got_w)
    np.testing.assert_array_equal(gray2.numpy(), got_gray[5:])


@pytest.mark.parametrize("fast", [False, True])
def test_simulate_frames_matches_jax(fast, scans):
    comp = scans[0][:6]
    if fast:
        ref = jfs.simulate_frames_fast(comp, jfs.FrameSimConfig(m=20, n=20))
        got = tfs.simulate_frames_fast(comp, tfs.FrameSimConfig(m=20, n=20), device="cpu")
    else:
        ref = jfs.simulate_frames(comp, jfs.FrameSimConfig(m=20, n=20))
        got = tfs.simulate_frames(comp, tfs.FrameSimConfig(m=20, n=20), device="cpu")
    assert set(got) == set(ref)
    np.testing.assert_allclose(got["w_final"].numpy(), _np(ref["w_final"]), rtol=0, atol=2e-6)
    np.testing.assert_allclose(got["resistances"].numpy(), _np(ref["resistances"]),
                               rtol=2e-5, atol=0)
    for key in ("diff_voltages", "value_matrices"):
        np.testing.assert_allclose(got[key].numpy(), _np(ref[key]), rtol=1e-6, atol=1e-5)


@pytest.fixture(scope="module")
def events():
    return jsyn.generate_synthetic_events(height=48, width=64, box_h=12, box_w=12,
                                          speed_pps=300, duration_s=0.4)


def test_synthetic_events_equal():
    for kw in ({}, {"height": 16, "width": 16, "box_h": 4, "box_w": 4, "speed_pps": 16,
                    "duration_s": 1.0}, {"height": 20, "width": 30, "duration_s": 0.0}):
        for a, b in zip(tsyn.generate_synthetic_events(**kw), jsyn.generate_synthetic_events(**kw)):
            np.testing.assert_array_equal(a, b)


def _assert_binned_equal(a, b):
    for key in BIN_KEYS:
        x, y = np.asarray(getattr(a, key)), np.asarray(getattr(b, key))
        assert x.dtype == y.dtype and x.shape == y.shape, key
        np.testing.assert_array_equal(x, y, err_msg=key)
    assert (a.height, a.width, a.slice_us) == (b.height, b.width, b.slice_us)


@pytest.mark.parametrize("kw", [{}, {"height": 50, "width": 70},
                                {"t_origin": 0, "n_slices": 450},
                                {"t_origin": 120_000, "n_slices": 64},
                                {"t_origin": 5_000}, {"n_slices": 10}])
def test_binners_match_each_other_and_jax(events, kw):
    x, y, p, t = events
    p = np.where(np.arange(p.size) % 3 == 0, 0, p)  # some OFF events with p == 0
    assert native.native_available(), native.build_error()
    nat = tev.bin_events(x, y, p, t, 1000, **kw)
    num = tev.bin_events(x, y, p, t, 1000, use_native=False, **kw)
    ref = jev.bin_events(x, y, p, t, 1000, use_native=False, **kw)
    _assert_binned_equal(nat, num)
    _assert_binned_equal(num, ref)


def test_binners_empty_stream():
    e = np.array([], dtype=np.int64)
    for kw in ({}, {"t_origin": 0, "n_slices": 5}):
        nat = tev.bin_events(e, e, e, e, 1000, 4, 6, **kw)
        _assert_binned_equal(nat, jev.bin_events(e, e, e, e, 1000, 4, 6, use_native=False, **kw))


def test_bin_events_raises_without_native_library(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", "no compiler")
    with pytest.raises(RuntimeError, match="use_native=False"):
        tev.bin_events(np.array([1]), np.array([1]), np.array([1]), np.array([0]))


CASES = [(1, "split"), (2, "split"), (2, "magnitude")]


def _event_cfgs(version, polarity):
    kw = dict(version=version, polarity=polarity, refractory_us=1500)
    return jev.EventSimConfig(**kw), tev.EventSimConfig(**kw)


def _assert_sim_close(got, ref, keys):
    for key in keys:
        g, r = got[key], _np(ref[key])
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        assert g.shape == r.shape, key
        np.testing.assert_allclose(g, r, rtol=0 if "res" not in key else 2e-6,
                                   atol=1e-6 if "res" not in key else 0, err_msg=key)


@pytest.mark.parametrize("version,polarity", CASES)
def test_simulate_events_matches_jax(events, version, polarity):
    x, y, p, t = events
    p = np.where(np.arange(p.size) % 3 == 0, 0, p)
    jcfg, tcfg = _event_cfgs(version, polarity)
    binned = jev.bin_events(x, y, p, t, 1000, use_native=False)
    ref = jev.simulate_events(binned, jcfg)
    got = tev.simulate_events(binned, tcfg, device="cpu")
    _assert_sim_close(got, ref, ("w_final", "resistances", "w_final_b", "resistances_b"))
    for a, b in zip(got["state"]["next_ok"], ref["state"]["next_ok"]):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    oracle = tev.simulate_events_reference(binned, tcfg)
    np.testing.assert_allclose(got["w_final"].numpy(), oracle["w_final"], rtol=0, atol=0)


@pytest.mark.parametrize("version,polarity", CASES)
def test_simulate_events_resumes_and_chunks_like_jax(events, version, polarity):
    """A carry resumed with a time offset, and the chunked long-stream
    driver, against the JAX package's."""
    x, y, p, t = events
    p = np.where(np.arange(p.size) % 3 == 0, 0, p)
    jcfg, tcfg = _event_cfgs(version, polarity)
    split = 200_000
    a, b = t < split, t >= split
    j1 = jev.simulate_events(jev.bin_events(x[a], y[a], p[a], t[a], 1000, 48, 64,
                                            use_native=False), jcfg)
    t1 = tev.simulate_events(tev.bin_events(x[a], y[a], p[a], t[a], 1000, 48, 64), tcfg,
                             device="cpu")
    kw = dict(t_origin=split, n_slices=300)
    j2 = jev.simulate_events(jev.bin_events(x[b], y[b], p[b], t[b], 1000, 48, 64,
                                            use_native=False, **kw),
                             jcfg, initial_state=j1["state"], time_offset=split)
    t2 = tev.simulate_events(tev.bin_events(x[b], y[b], p[b], t[b], 1000, 48, 64, **kw),
                             tcfg, initial_state=t1["state"], time_offset=split, device="cpu")
    _assert_sim_close(t2, j2, ("w_final", "resistances", "w_final_b"))
    js = jev.simulate_events_stream(x, y, p, t, 1000, jcfg, chunk_slices=128)
    ts = tev.simulate_events_stream(x, y, p, t, 1000, tcfg, chunk_slices=128, device="cpu")
    _assert_sim_close(ts, js, ("w_final", "resistances", "w_final_b", "resistances_b"))


def test_io_writers_match_jax(tmp_path, events):
    w = np.random.default_rng(1).random((6, 8)).astype(np.float32)
    res = np.random.default_rng(2).random((3, 6, 8))
    tio.save_sim_npz(tmp_path / "t.npz", torch.from_numpy(w), res)
    jio.save_sim_npz(tmp_path / "j.npz", w, res)
    with np.load(tmp_path / "t.npz") as a, np.load(tmp_path / "j.npz") as b:
        for key in ("w_final", "resistances"):
            np.testing.assert_array_equal(a[key], b[key])
            assert a[key].dtype == b[key].dtype
    tio.save_sim_metadata(tmp_path / "t.json.gz", tev.EventSimConfig(version=2), 1000, "e.h5")
    jio.save_sim_metadata(tmp_path / "j.json.gz", jev.EventSimConfig(version=2), 1000, "e.h5")
    meta = [json.load(gzip.open(tmp_path / f"{n}.json.gz", "rt")) for n in "tj"]
    assert meta[0] == meta[1]
    pytest.importorskip("h5py")
    tio.save_events_h5(tmp_path / "ev.h5", *events)
    got = tio.load_events_h5(tmp_path / "ev.h5")
    ref = jio.load_events_h5(tmp_path / "ev.h5")
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
