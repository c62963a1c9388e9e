"""The tracking and prediction paths on the card.

The image-scale labelling (``label_components_sweep``) on CUDA equals the
CPU version, and ``tracking_batch_fast`` / ``prediction_batch_fast`` in
``kernel_mode='fused'`` (K1–K4) equal the plain route (every kernel
wrapper on its plain version, ``chip_smoke.plain_route``) on a 120×160
grasp cut with a 64×96 window, B = 4.  ``stream_masks`` in 'auto' (K8 and
K1–K4) and ``stream_masks_chunked`` equal the plain route on 9 frames of
that cut with a textured block moving (2, 3) px a frame, n_substeps 1000.
``deep_roi_flow_batch`` on RAFT-small and RAFT-basic (K1 on RGB windows)
equals the plain route and, with cuDNN's TF32 off, the CPU within 1e-3 px.
One RAFT train step (``make_train_step``, 64×96, B = 2) on the card equals
the CPU port's to the CPU tests' bounds (``chip_smoke.drive_train_parity``),
launches no kernel of the port and makes no host synchronisation.
The ground-truth tooling at its test sizes: ``SamPredictor`` (``TINY_SAM``)
and ``TorchOwlVitBoxProposer`` (``TINY_OWLVIT``) on the card against the CPU
port, cuDNN's TF32 off, within ``chip_smoke``'s GT_SAM_F32_REL and
GT_OWL_F32_REL, no kernel of the port launched.  ``OwlVitBoxProposer`` and
``TransformersSamSegmenter`` built without a device, from tiny local
Hugging Face directories (``tests/tiny_hf.py``), run on the card (skipped
where ``transformers`` is missing).

Needs the card: ``python -m pytest --noconftest -m cuda
tests/test_torch_paths_cuda.py`` (the card's machine has no jax, which the
repo's conftest imports).  Skipped without a CUDA device.
"""

import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import (GT_OWL_F32_REL, GT_SAM_F32_REL, bgr, f32_convs, gap, gt_sam,
                        plain_route)
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


@pytest.mark.cuda
@pytest.mark.parametrize("small", [True, False], ids=["raft-small", "raft-basic"])
def test_deep_roi_flow_batch_on_the_card(cuda_device, small):
    """``deep_roi_flow_batch`` on RGB frames of the 120×160 cut (memsize
    20, so 6 on the deep grid), RAFT at 3 iterations with random weights:
    K1 launched twice (a 3-byte element), the output equal to the plain
    route's, and the flow within 1e-3 px of the same model on the CPU with
    cuDNN's TF32 off."""
    import copy

    from nsof_tpu_torch.models.raft import RAFT, RaftConfig
    from nsof_tpu_torch.pipelines import deep_flow as tdf

    torch.manual_seed(0)
    model = RAFT(RaftConfig(small=small, corr_radius=3 if small else 4, iters=3))
    cpu = tdf.DeepBackend.from_raft(copy.deepcopy(model), iters=3, device="cpu")
    card = tdf.DeepBackend.from_raft(model, iters=3, device=cuda_device)
    mem, prev, nxt = _inputs(3, cuda_device)
    mem = torch.zeros((3, H // 6, W // 6), dtype=torch.uint8, device=cuda_device)
    mem[:, 5:9, 8:12] = 255
    prev, nxt = bgr(prev), bgr(nxt)
    cfg = _cfg()
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        _build.reset_launches()
        out = tdf.deep_roi_flow_batch(mem, prev, nxt, cfg, card)
        torch.cuda.synchronize()
        assert {k: v for k, v in _build.LAUNCHES.items() if v} == {"crop_windows": 2}
        with plain_route():
            ref = tdf.deep_roi_flow_batch(mem, prev, nxt, cfg, card)
        for k in out:
            assert torch.equal(out[k], ref[k]), k
        want = tdf.deep_roi_flow_batch(mem.cpu(), prev.cpu(), nxt.cpu(), cfg, cpu)
    assert out["any_active"].all()
    torch.testing.assert_close(out["flow"].cpu(), want["flow"], rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_train_step_on_the_card(cuda_device):
    from chip_smoke import drive_train_parity, host_syncs, train_batch
    from nsof_tpu_torch.models.raft import RaftConfig
    from nsof_tpu_torch.parallel import train as ptrain

    drive_train_parity(cuda_device)  # raises past the bounds
    model, tx, state = ptrain.create_train_state(0, cuda_device, cfg=RaftConfig(small=True,
                                                                              iters=2))
    step = ptrain.make_train_step(model, tx, cuda_device, iters=2)
    batch = train_batch(2, 64, 96, seed=4)
    step(state, batch)
    torch.cuda.synchronize()
    _build.reset_launches()
    assert host_syncs(lambda: step(state, batch)) == {}
    torch.cuda.synchronize()
    assert not any(_build.LAUNCHES.values()) and state.step == 2


@pytest.mark.cuda
def test_sam_predictor_on_the_card(cuda_device):
    from nsof_tpu_torch.models import sam as tsam

    img = np.random.default_rng(0).integers(0, 256, (60, 80, 3), dtype=np.uint8)
    boxes = np.array([[5, 6, 50, 40], [0, 0, 80, 60]], np.float32)
    cpu = tsam.SamPredictor(gt_sam(tsam.TINY_SAM), device="cpu")
    cpu.set_image(img)
    want = cpu.predict(boxes=boxes, return_logits=True)
    card = tsam.SamPredictor(gt_sam(tsam.TINY_SAM, cuda_device), device=cuda_device)
    _build.reset_launches()
    with f32_convs():
        card.set_image(img)
        got = card.predict(boxes=boxes, return_logits=True)
    assert not any(_build.LAUNCHES.values())
    for g, w in zip(got, want):
        assert gap(g, w) <= GT_SAM_F32_REL


@pytest.mark.cuda
def test_owlvit_proposer_on_the_card(cuda_device):
    from nsof_tpu_torch.data import gt_tooling as tgt
    from nsof_tpu_torch.models import owlvit as towl

    cfg = towl.TINY_OWLVIT
    state = towl.synthetic_owlvit_state_dict(cfg, seed=5)
    tok = tgt.toy_tokenizer(cfg.vocab_size, cfg.max_text_len)
    img = np.random.default_rng(1).integers(0, 256, (48, 64, 3), dtype=np.uint8)
    props = [tgt.TorchOwlVitBoxProposer.from_params(cfg, state, tok, -1.0, device=d)
             for d in ("cpu", cuda_device)]
    with f32_convs():
        want, got = (np.asarray(p(img, "moving object")) for p in props)
    assert got.shape == want.shape == (16, 4)
    assert np.abs(got - want).max() <= GT_OWL_F32_REL * max(img.shape)


@pytest.mark.cuda
def test_hf_classes_default_to_the_card(cuda_device, tmp_path):
    pytest.importorskip("transformers")
    from tiny_hf import drive_hf_classes, tiny_hf_dirs

    owl, seg, _ = drive_hf_classes(*tiny_hf_dirs(tmp_path))
    assert owl.device.type == seg.device.type == "cuda"
