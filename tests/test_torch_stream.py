"""The port's streaming pipelines against the JAX package's.

``tests/test_stream.py``'s setup: 160×160 frames with a bright 40×40 box
moving 3 px a frame to the right, 14 frames, the device grid at 20 px a cell
(8×8), default device constants, the merged-box (FLAG=2) config with the
activity threshold taken from the device maps, warp radius 1 (the JAX 'xla'
route compiles (2r+2)² warp taps; radius 1 keeps this file near 40 s).
Inputs are made with numpy.

- ``stream_masks`` (``device='cpu'``) against the jitted JAX one, both in
  ``kernel_mode='xla'`` (the JAX package's 'auto' off the TPU): boxes,
  ``any_active`` and ``region_pct`` equal, masks ≥ 99.5 % equal, the
  scattered flow within PERF.md §2's 1e-2 px max and 5e-4 px mean,
  ``mem_gray`` within one level at ≥ 99 % equal and ``w_final`` within 2e-6
  (the JAX scan is jitted: XLA fuses products into adds).  Measured on the CPU:
  masks and ``mem_gray`` 100 % equal.
- ``stream_masks_chunked`` equals the one-shot call bit for bit, at chunk
  sizes that divide the pairs and that leave a tail; the ``w0``
  continuation of the scan gives the whole scan's maps bit for bit.
- ``stream_masks_from_events`` on ``test_event_gated_stream``'s setup
  (16×16 event grid, memsize 10, 11 frames at 10 fps) against the JAX one:
  the carried state within 1e-6, the gate maps within one count, boxes
  equal, masks ≥ 99.5 % equal; the chained state equals one un-chunked
  event simulation.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsof_tpu.config import PipelineConfig as JConfig
from nsof_tpu.device import frame_sim as jfs
from nsof_tpu.device.event_sim import EventSimConfig as JEventCfg
from nsof_tpu.device.synthetic import generate_synthetic_events
from nsof_tpu.ops.roi import RoiConfig as JRoi
from nsof_tpu.pipelines import stream as jstream
from nsof_tpu_torch.config import config_from_dict
from nsof_tpu_torch.device import event_sim as tev
from nsof_tpu_torch.device import frame_sim as tfs
from nsof_tpu_torch.pipelines import stream as tstream

H = W = 160
BOX = 40
SPEED = 3


def _moving_box_frames(t=14):
    frames = np.full((t, H, W), 20, np.uint8)
    for i in range(t):
        frames[i, 60 : 60 + BOX, 8 + SPEED * i : 8 + SPEED * i + BOX] = 220
    return frames


def _cfgs(thres, memsize=20):
    cfg = JConfig(name="stream-test", image_h=H, image_w=W,
                  roi=JRoi(memsize=memsize, thres=thres, mode=2), warp_radius=1)
    return cfg, config_from_dict(dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def setup():
    frames = _moving_box_frames()
    sim = tfs.FrameSimConfig(m=20, n=20)
    comp = tfs.compress_frames(torch.from_numpy(frames).float() / 255.0, 20, 20, device="cpu")
    _, mem, _ = tfs.scan_device(comp, sim, torch.full((8, 8), 0.5))
    mem = mem.numpy()
    thres = int((int(mem[-1, 3:5, 1:4].min()) + int(mem[-1, 0, 7])) // 2)
    return frames, sim, thres


@pytest.fixture(scope="module")
def one_shot(setup):
    frames, sim, thres = setup
    jcfg, tcfg = _cfgs(thres)
    ref = jstream.stream_masks(jnp.asarray(frames), jcfg, jfs.FrameSimConfig(m=20, n=20),
                               kernel_mode="xla", return_flow=True)
    got = tstream.stream_masks(frames, tcfg, sim, kernel_mode="xla", return_flow=True,
                               device="cpu")
    return tcfg, {k: np.array(v) for k, v in ref.items()}, got


def test_stream_masks_matches_jax(one_shot):
    _, ref, got = one_shot
    assert set(got) == set(ref)
    for key in ("boxes", "any_active", "region_pct"):
        np.testing.assert_array_equal(got[key].numpy(), ref[key], err_msg=key)
    assert got["masks"].dtype == torch.uint8 and got["masks"].shape == (13, H, W)
    assert (got["masks"].numpy() == ref["masks"]).mean() >= 0.995
    assert got["any_active"][3:].all() and got["masks"][-1].sum() > 0
    err = np.abs(got["flow"].numpy() - ref["flow"])
    assert err.max() <= 1e-2 and err.mean() <= 5e-4, (err.max(), err.mean())
    d = np.abs(got["mem_gray"].numpy().astype(int) - ref["mem_gray"].astype(int))
    assert d.max() <= 1 and (d == 0).mean() >= 0.99
    np.testing.assert_allclose(got["w_final"].numpy(), ref["w_final"], rtol=0, atol=2e-6)


@pytest.mark.parametrize("chunk", [5, 4])
def test_chunked_equals_one_shot(setup, one_shot, chunk):
    frames, sim, _ = setup
    tcfg, _, one = one_shot
    got = tstream.stream_masks_chunked(frames, tcfg, sim, chunk_pairs=chunk,
                                       kernel_mode="xla", device="cpu")
    assert set(got) == set(one) - {"flow"}
    for key, val in got.items():
        assert torch.equal(val, one[key]), key


def test_w0_continuation_matches_whole_scan(setup):
    frames, sim, _ = setup
    comp = tfs.compress_frames(torch.from_numpy(frames).float() / 255.0, 20, 20, device="cpu")
    w0 = torch.full((8, 8), 0.5)
    w_all, mem, _ = tfs.scan_device(comp, sim, w0)
    wa, ma, _ = tfs.scan_device(comp[:8], sim, w0)
    wb, mb, _ = tfs.scan_device(comp[7:], sim, wa)
    assert torch.equal(torch.cat([ma, mb]), mem) and torch.equal(wb, w_all)


def _event_setup():
    x, y, p, t = generate_synthetic_events(height=16, width=16, box_h=4, box_w=4,
                                           speed_pps=16, duration_s=1.0)
    frame_t = np.arange(11, dtype=np.int64) * 100_000
    frames = np.full((11, H, W), 20, np.uint8)
    for i in range(11):
        gx0 = int(frame_t[i] / 1e6 * 16)
        frames[i, 60:100, gx0 * 10 : (gx0 + 4) * 10] = 220
    return (x, y, p, t), frames, frame_t


@pytest.mark.parametrize("version,polarity", [(1, "magnitude"), (2, "split")])
def test_event_gated_stream_matches_jax(version, polarity):
    (x, y, p, t), frames, frame_t = _event_setup()
    jcfg, tcfg = _cfgs(thres=20, memsize=10)
    kw = dict(version=version, polarity=polarity)
    ref = jstream.stream_masks_from_events(x, y, p, t, frames, frame_t, jcfg, (16, 16),
                                           event_cfg=JEventCfg(**kw), kernel_mode="xla")
    got = tstream.stream_masks_from_events(x, y, p, t, frames, frame_t, tcfg, (16, 16),
                                           event_cfg=tev.EventSimConfig(**kw),
                                           kernel_mode="xla", device="cpu")
    for a, b in zip(got["state"]["w"], ref["state"]["w"]):
        np.testing.assert_allclose(a.numpy(), np.array(b), rtol=0, atol=1e-6)
    for a, b in zip(got["state"]["next_ok"], ref["state"]["next_ok"]):
        np.testing.assert_array_equal(a.numpy(), np.array(b))
    gate = np.abs(got["mem_gate"].numpy().astype(int) - np.array(ref["mem_gate"]).astype(int))
    assert gate.max() <= 1
    for key in ("boxes", "any_active", "region_pct"):
        np.testing.assert_array_equal(got[key].numpy(), np.array(ref[key]), err_msg=key)
    assert (got["masks"].numpy() == np.array(ref["masks"])).mean() >= 0.995
    if version == 1:
        assert got["any_active"].any()
        # the chained interval state is one un-chunked simulation's
        sel = t < frame_t[-1]
        binned = tev.bin_events(x[sel], y[sel], p[sel], t[sel], 1000, 16, 16, t_origin=0,
                                n_slices=1000)
        one = tev.simulate_events(binned, tev.EventSimConfig(**kw), device="cpu")
        np.testing.assert_allclose(got["state"]["w"][0].numpy(), one["w_final"].numpy(),
                                   rtol=0, atol=1e-6)
