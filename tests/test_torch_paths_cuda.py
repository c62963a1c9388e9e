"""The tracking and prediction paths on the card.

The image-scale labelling (``label_components_sweep``) on CUDA equals the
CPU version, and ``tracking_batch_fast`` / ``prediction_batch_fast`` in
``kernel_mode='fused'`` (K1–K4) equal the plain route (every kernel
wrapper on its plain version, ``chip_smoke.plain_route``) on a 120×160
grasp cut with a 64×96 window, B = 4.  ``stream_masks`` in 'auto' (K8,
K1–K4, K10 and K13) and ``stream_masks_chunked`` equal the plain route on 9 frames of
that cut with a textured block moving (2, 3) px a frame, n_substeps 1000.
``deep_roi_flow_batch`` on RAFT-small and RAFT-basic (K1 on RGB windows)
equals the plain route and, with cuDNN's TF32 off, the CPU within 1e-3 px;
RAFT's update block runs channels-last there, with no cuDNN layout
conversion inside its ``nsof.raft.update`` spans.
One RAFT train step (``make_train_step``, 64×96, B = 2) on the card equals
the CPU port's to the CPU tests' bounds (``chip_smoke.drive_train_parity``),
launches no kernel of the port and makes no host synchronisation.
The ground-truth tooling at its test sizes: ``SamPredictor`` (``TINY_SAM``),
the batched ``sam_gt_batch`` (no host synchronisation once warm) and
``TorchOwlVitBoxProposer`` (``TINY_OWLVIT``) on the card against the CPU
port, cuDNN's TF32 off, within ``chip_smoke``'s GT_SAM_F32_REL and
GT_OWL_F32_REL, no kernel of the port launched.  ``OwlVitBoxProposer`` and
``TransformersSamSegmenter`` built without a device, from tiny local
Hugging Face directories (``tests/tiny_hf.py``), run on the card (skipped
where ``transformers`` is missing).  ``make_sharded_seg_batch`` on
``make_mesh(1)`` at world size 1 over NCCL (B = 4, ``'fused'``) launches K1–K4, K10,
K12, K13 and equals ``seg_batch_fast`` bit for bit.

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
    assert _build.LAUNCHES["seg_head"] == 1 and _build.LAUNCHES["scatter_window"] == 1
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
    K1 launched twice (a 3-byte element) and K10 once, the output equal to the plain
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
        assert {k: v for k, v in _build.LAUNCHES.items() if v} == {"crop_windows": 2,
                                                                   "seg_head": 1}
        with plain_route():
            ref = tdf.deep_roi_flow_batch(mem, prev, nxt, cfg, card)
        for k in out:
            assert torch.equal(out[k], ref[k]), k
        want = tdf.deep_roi_flow_batch(mem.cpu(), prev.cpu(), nxt.cpu(), cfg, cpu)
    assert out["any_active"].all()
    torch.testing.assert_close(out["flow"].cpu(), want["flow"], rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_raft_update_runs_channels_last_on_the_card(cuda_device, tmp_path):
    """RAFT-basic at 46×80 on the 1/8 grid (368×640 frames), B = 2, 4
    refinements: every refinement's update block runs channels-last
    (``COUNTS['raft_update_nhwc']``), its convolution weights are stored so,
    and no cuDNN layout conversion (``nchwToNhwc`` / ``nhwcToNchw``) runs
    inside an ``nsof.raft.update`` span of the traced call."""
    from benchmark.spans import Spans
    from benchmark.trace import traced
    from nsof_tpu_torch.models.raft import RAFT, RaftConfig

    torch.manual_seed(0)
    model = RAFT(RaftConfig(iters=4)).to(cuda_device).eval()
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    a, b = (torch.randint(0, 256, (2, 368, 640, 3), generator=gen, device=cuda_device,
                          dtype=torch.uint8) for _ in range(2))
    with torch.inference_mode():
        model(a, b, test_mode=True)  # stores the weights, warms cuDNN up
        _build.reset_launches()
        with traced(tmp_path / "raft.trace.json", with_stack=False) as got:
            model(a, b, test_mode=True)
    assert _build.COUNTS["raft_update_nhwc"] == 4
    convs = [m for m in model.update_block.modules() if isinstance(m, torch.nn.Conv2d)]
    assert len(convs) == 15
    assert all(m.weight.is_contiguous(memory_format=torch.channels_last) for m in convs)
    spans = Spans(got[0])
    names = [n for v in spans.spans.values() for *_, n in v]
    assert names.count("nsof.raft.update") == 4
    update = [op[2] for op, path in spans.ops if "nsof.raft.update" in path]
    assert len(update) > 4 * 15, update
    layout = [k for k in update if "nchwToNhwc" in k or "nhwcToNchw" in k]
    assert not layout, layout


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
def test_sam_gt_batch_on_the_card(cuda_device):
    """The batched ground-truth step on three frames with 0, 1 and 3 boxes:
    the card against the CPU port within GT_SAM_F32_REL, cuDNN's TF32 off,
    and once warm (its resize taps and pixel statistics uploaded) no host
    synchronisation."""
    from nsof_tpu_torch.data.gt_tooling import sam_gt_batch
    from nsof_tpu_torch.models import sam as tsam

    frames = torch.from_numpy(
        np.random.default_rng(2).integers(0, 256, (3, 60, 80, 3), dtype=np.uint8))
    boxes = torch.tensor([[5, 6, 50, 40], [0, 0, 80, 60], [10, 20, 30, 50], [40, 5, 79, 59]],
                         dtype=torch.float32)
    owner = torch.tensor([1, 2, 2, 2])
    want = sam_gt_batch(gt_sam(tsam.TINY_SAM), frames, boxes, owner)
    model = gt_sam(tsam.TINY_SAM, cuda_device)
    args = (frames.to(cuda_device), boxes.to(cuda_device), owner.to(cuda_device))
    with f32_convs():
        sam_gt_batch(model, *args)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = sam_gt_batch(model, *args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    for key in ("low_res", "iou"):
        assert gap(got[key], want[key]) <= GT_SAM_F32_REL, key
    assert (got["mask"].cpu() != want["mask"]).float().mean() <= 1e-3
    assert not got["mask"][0].any()


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


@pytest.mark.cuda
def test_sharded_seg_over_nccl(cuda_device):
    import torch.distributed as dist

    from nsof_tpu_torch.parallel.inference import make_sharded_seg_batch
    from nsof_tpu_torch.parallel.mesh import make_mesh
    from nsof_tpu_torch.pipelines.segmentation import seg_batch_fast

    mesh = make_mesh(1)
    try:
        assert dist.get_backend() == "nccl"
        cfg = _cfg()
        mem, prev, nxt = _inputs(4, cuda_device)
        torch.cuda.synchronize()
        _build.reset_launches()
        got = make_sharded_seg_batch(mesh, cfg, kernel_mode="fused")(mem, prev, nxt)
        torch.cuda.synchronize()
        launched = {k for k, v in _build.LAUNCHES.items() if v}
        assert launched == {"crop_windows", "pyramid_blur", "poly_expansion",
                            "update_matrices_sep", "fused_box_update",
                            "fused_box_update_strip", "seg_head", "scatter_window"}
        want = seg_batch_fast(mem, prev, nxt, cfg, kernel_mode="fused")
        for key in ("mask", "box", "any_active"):
            assert torch.equal(got[key], want[key]), key
        assert got["mask"].device.type == "cuda" and got["any_active"].dtype == torch.bool
    finally:
        dist.destroy_process_group()
