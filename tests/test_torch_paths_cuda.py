"""The tracking and prediction paths on the card.

The image-scale labelling (``label_components_sweep``) on CUDA equals the
CPU version, and ``tracking_batch_fast`` / ``prediction_batch_fast`` in
``kernel_mode='fused'`` (K1–K4) equal the plain route (every kernel
wrapper on its plain version, ``chip_smoke.plain_route``) on a 120×160
grasp cut with a 64×96 window, B = 4.  ``stream_masks`` in 'auto' (K8 and
K1–K4) and ``stream_masks_chunked`` equal the plain route on 9 frames of
that cut with a textured block moving (2, 3) px a frame, n_substeps 1000.

Needs the card: ``python -m pytest --noconftest -m cuda
tests/test_torch_paths_cuda.py`` (the card's machine has no jax, which the
repo's conftest imports).  Skipped without a CUDA device.
"""

import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import bgr, plain_route
from nsof_tpu_torch.config import DATASETS
from nsof_tpu_torch.ops import components as tcc
from nsof_tpu_torch import _build
from nsof_tpu_torch.device.frame_sim import FrameSimConfig
from nsof_tpu_torch.pipelines import stream as tstream
from nsof_tpu_torch.pipelines.prediction import prediction_batch_fast
from nsof_tpu_torch.pipelines.tracking import tracking_batch_fast

H, W, MEMSIZE = 120, 160, 20


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _cfg():
    cfg = dataclasses.replace(DATASETS["grasp"], name="cut120", image_h=H, image_w=W,
                              window_h=64, window_w=96, warp_radius=3)
    return dataclasses.replace(cfg, roi=dataclasses.replace(cfg.roi, memsize=MEMSIZE))


def _inputs(b, dev):
    rng = np.random.default_rng(0)
    base = rng.random((H + 64, W + 64)).astype(np.float32) * 255
    prev = np.stack([base[16 + v : 16 + v + H, 16 : 16 + W] for v in range(b)])
    nxt = np.stack([base[18 + v : 18 + v + H, 15 : 15 + W] for v in range(b)])
    mem = np.zeros((b, H // MEMSIZE, W // MEMSIZE), np.uint8)
    for i in range(b):
        mem[i, i % 4 : i % 4 + 2, i : i + 2] = 255
    t = lambda a: torch.from_numpy(a.astype(np.uint8)).to(dev)  # noqa: E731
    return t(mem), t(prev), t(nxt)


@pytest.mark.cuda
@pytest.mark.parametrize("connectivity", [4, 8])
def test_sweep_labelling_cuda_equals_cpu(cuda_device, connectivity):
    rng = np.random.default_rng(connectivity)
    masks = np.stack([rng.random((256, 384)) < p for p in (0.3, 0.55, 0.8)])
    snake = np.zeros((256, 384), bool)
    snake[::2] = True
    snake[1::4, -1] = True
    snake[3::4, 0] = True
    masks = torch.from_numpy(np.concatenate([masks, snake[None]]))
    got = tcc.label_components_sweep(masks.to(cuda_device), connectivity)
    ref = tcc.label_components_sweep(masks, connectivity)
    assert torch.equal(got.cpu(), ref)
    for k_max in (16, 32):
        gs = tcc.component_stats_scatter(got, k_max)
        rs = tcc.component_stats_scatter(ref, k_max)
        for key in ("boxes", "areas", "valid", "count"):
            assert torch.equal(gs[key].cpu(), rs[key]), key


@pytest.mark.cuda
def test_tracking_fused_equals_plain_route(cuda_device):
    mem, prev, nxt = _inputs(4, cuda_device)
    got = tracking_batch_fast(mem, prev, nxt, _cfg(), kernel_mode="fused")
    with plain_route():
        ref = tracking_batch_fast(mem, prev, nxt, _cfg(), kernel_mode="fused")
    for key in ("boxes", "valid", "areas", "box", "any_active"):
        assert torch.equal(got[key], ref[key]), key
    assert got["valid"].any(dim=1).all()


@pytest.mark.cuda
def test_prediction_fused_equals_plain_route(cuda_device):
    mem, prev, nxt = _inputs(4, cuda_device)
    frame = bgr(nxt)
    got = prediction_batch_fast(mem, prev, nxt, frame, _cfg(), kernel_mode="fused")
    with plain_route():
        ref = prediction_batch_fast(mem, prev, nxt, frame, _cfg(), kernel_mode="fused")
    for key in ("pred", "flow", "box", "any_active"):
        assert torch.equal(got[key], ref[key]), key
    assert (got["pred"] != frame).any()


@pytest.mark.cuda
def test_stream_kernels_equal_plain_route(cuda_device):
    rng = np.random.default_rng(3)
    base = (rng.random((H, W)) * 96).astype(np.uint8)
    frames = np.broadcast_to(base, (9, H, W)).copy()
    for i in range(9):
        frames[i, 20 + 2 * i : 60 + 2 * i, 30 + 3 * i : 70 + 3 * i] = 230
    frames = torch.from_numpy(frames).to(cuda_device)
    cfg = dataclasses.replace(_cfg(), roi=dataclasses.replace(_cfg().roi, thres=240))
    sim = FrameSimConfig(m=MEMSIZE, n=MEMSIZE)
    _build.reset_launches()
    got = tstream.stream_masks(frames, cfg, sim)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["device_scan"] == 1 and _build.LAUNCHES["crop_windows"] == 2
    assert got["any_active"].all() and got["masks"].any()
    chunked = tstream.stream_masks_chunked(frames, cfg, sim, chunk_pairs=3)
    with plain_route():
        ref = tstream.stream_masks(frames, cfg, sim)
    for key, val in ref.items():
        assert torch.equal(got[key], val), key
        assert torch.equal(chunked[key], val), key
