"""The reference against the port's plain path on the CPU, at small sizes:
the segmentation step on both routes, and the device simulation."""

import numpy as np
import pytest
import torch

from benchmark import inputs
from benchmark.conftest import small_cell
from benchmark.reference import frame_sim as ref_sim
from benchmark.reference import segmentation as ref_seg


@pytest.mark.parametrize("name", ["grasp.batch", "autodriving.batch"])
def test_seg_step_equals_the_port(name):
    from nsof_tpu_torch.pipelines.segmentation import seg_batch_fast

    cell = small_cell(name)
    mem, prev, nxt = inputs.pairs(cell.seed, cell.config, cell.params, 6, "cpu")
    got = seg_batch_fast(mem, prev, nxt, cell.pipeline_config(), return_flow=True,
                         device="cpu")
    want = ref_seg.seg_step(mem, prev, nxt, cell.config)
    assert want["any_active"].any() and not want["any_active"].all()
    assert want["mask"].any()
    for key in ("mask", "flow", "box", "any_active"):
        assert torch.equal(got[key], want[key]), key


def test_scan_and_compression_follow_the_port():
    from nsof_tpu_torch.device import frame_sim as tfs
    from nsof_tpu_torch.device.model import _div

    cell = small_cell("grasp.stream")
    s = cell.params["sim"]
    frames = inputs.sequence(cell.seed, cell.config, cell.params, "cpu")[:9]
    comp = tfs.compress_frames(_div(frames.float(), 255.0), s["m"], s["n"], device="cpu")
    assert torch.equal(ref_sim.compress(frames, s["m"], s["n"]), comp)
    sim = tfs.FrameSimConfig(m=s["m"], n=s["n"], th1=s["th1"], th2=s["th2"], dt=s["dt"],
                             n_substeps=s["n_substeps"])
    w0 = torch.full(comp.shape[1:], 0.5)
    w, gray, _ = tfs.scan_device_plain(comp, sim, w0)
    w_ref, gray_ref = ref_sim.scan(comp.double().numpy(), s, w0.double().numpy())
    assert np.abs(w.double().numpy() - w_ref).max() < 1e-5
    assert np.abs(gray.numpy().astype(int) - np.floor(gray_ref)).max() <= 1
    assert len(np.unique(gray.numpy())) > 2  # the states move
