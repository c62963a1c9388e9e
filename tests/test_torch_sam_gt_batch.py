"""The port's batched ground-truth step (``nsof_tpu_torch/data/gt_tooling.py::
sam_gt_batch``) and its device resize (``ops/resize.py::resize_linear_u8``)
on the CPU, with no JAX.

- ``resize_linear_u8`` equals ``data/imgproc.py::resize_linear`` bit for
  bit on uint8 RGB frames of odd sizes, shrinking and growing, grasp's
  1920×1080 → 1024×576 included; the benchmark reference's own resize
  equals ``cv2.resize(INTER_LINEAR)`` where OpenCV imports.
- ``sam_gt_batch`` at ``TINY_SAM`` on three frames with 0, 1 and 3 boxes
  equals ``SamPredictor.set_image`` + ``predict`` frame by frame: the same
  low-res logits and IoU within 1e-5 of the largest (one encoder call on
  three frames against three calls on one: other matrix-product blockings;
  measured 4.4e-7),
  each frame's mask the OR of the predictor's masks, all False without a
  box; the step counts its frames and boxes and opens its span tree.
- The port against ``benchmark/reference/sam.py`` (written from the
  published code) on seeded weights at vit_h's widths (1280, 16 heads of 80,
  MLP 5120; the decoder at 256, 8 heads, MLP 2048), the depth cut to 2 —
  block 0 windowed, block 1 global — and ``img_size`` 480: 30×30 tokens
  zero-padded to 42×42, 9 windows of 14×14, as vit_h's 64×64 grid pads to
  70×70.  Bounds, of the largest magnitude: low-res logits 1e-4 and IoU 1e-4
  (float32 on both sides; the port's LayerNorm2d is ``F.layer_norm``, the
  reference's its own mean and variance; the port's rel-pos einsums and the
  reference's sum in other orders: measured 1.3e-6 and 7.7e-7); the masks
  at most 0.1 % of the frame apart (the port resizes the logits with JAX's
  weights as matrix products, the reference with ``F.interpolate``: a pixel
  whose logit is within rounding of 0 can flip; measured 0).  The frame,
  600×338, shrinks to 480×270 and both resizes of the logits grow, as
  grasp's 1920×1080 does at 1024: where the second one shrinks, the port's
  antialiased resize (the JAX package's) and the published bilinear one
  differ by more than rounding (1.7 % of a 300×170 frame).
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.reference import sam as ref_sam
from nsof_tpu_torch import _build
from nsof_tpu_torch.data import gt_tooling as tgt
from nsof_tpu_torch.data.imgproc import resize_linear
from nsof_tpu_torch.models import sam as ts
from nsof_tpu_torch.ops.resize import resize_linear_u8
from torch_single_thread import one_torch_thread  # noqa: F401  (autouse)

RESIZE_CASES = [((1920, 1080), (1024, 576)), ((37, 53), (64, 91)), ((97, 131), (41, 29)),
                ((61, 7), (5, 50)), ((96, 120), (102, 128))]


@pytest.mark.parametrize("src,dst", RESIZE_CASES)
def test_device_resize_bit_equal_to_resize_linear(src, dst):
    frames = np.random.default_rng(sum(src)).integers(0, 256, (2, *src, 3), dtype=np.uint8)
    (nh, nw) = dst
    got = resize_linear_u8(torch.from_numpy(frames), nw, nh).numpy()
    want = np.stack([resize_linear(f, nw, nh) for f in frames])
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    with pytest.raises(ValueError, match="uint8"):
        resize_linear_u8(torch.zeros((4, 4, 3)), 8, 8)


@pytest.mark.parametrize("src,dst", RESIZE_CASES[:3])
def test_reference_resize_equals_opencv(src, dst):
    cv2 = pytest.importorskip("cv2")
    img = np.random.default_rng(sum(dst)).integers(0, 256, (*src, 3), dtype=np.uint8)
    got = ref_sam.resize_linear_u8(torch.from_numpy(img), dst[1], dst[0]).numpy()
    assert np.array_equal(got, cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR))


def _tiny_model():
    """TINY_SAM on seed-7 weights, the mask head ×20 so that the frame
    decides the logits' sign (``tests/test_torch_sam.py``'s ``mixed_state``)."""
    state = ts.synthetic_sam_state_dict(ts.TINY_SAM, seed=7)
    for k in [k for k in state if k.endswith(("output_upscaling.3.weight", "layers.2.weight"))
              and "iou" not in k]:
        state[k] = state[k] * 20
    model = ts.Sam(ts.TINY_SAM)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model.eval()


FRAME_BOXES = [[], [[10, 8, 60, 50]], [[0, 0, 120, 96], [30, 40, 90, 70], [70, 5, 110, 35]]]


@pytest.fixture(scope="module")
def tiny_batch():
    model = _tiny_model()
    frames = np.random.default_rng(3).integers(0, 256, (3, 96, 120, 3), dtype=np.uint8)
    boxes = torch.tensor([b for bs in FRAME_BOXES for b in bs], dtype=torch.float32)
    owner = torch.tensor([i for i, bs in enumerate(FRAME_BOXES) for _ in bs])
    _build.reset_launches()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = tgt.sam_gt_batch(model, torch.from_numpy(frames), boxes, owner, instances=True)
    counts = {name: v for name, v in _build.COUNTS.items() if v}
    return model, frames, out, counts, prof


def test_batch_equals_the_predictor_frame_by_frame(tiny_batch):
    model, frames, out, _, _ = tiny_batch
    pred = ts.SamPredictor(model, device="cpu")
    assert out["mask"].shape == (3, 96, 120) and out["low_res"].shape == (4, 1, 32, 32)
    assert not out["mask"][0].any()
    k = 0
    for f, bs in enumerate(FRAME_BOXES[1:], start=1):
        pred.set_image(frames[f])
        masks, iou, low = pred.predict(boxes=np.asarray(bs, np.float32))
        top = np.abs(low).max()
        assert np.abs(out["low_res"][k : k + len(bs)].numpy() - low).max() <= 1e-5 * top
        assert np.abs(out["iou"][k : k + len(bs)].numpy() - iou).max() <= 1e-5 * np.abs(iou).max()
        assert np.array_equal(out["instances"][k : k + len(bs)].numpy(), masks[:, 0])
        assert np.array_equal(out["mask"][f].numpy(), masks[:, 0].any(axis=0))
        assert 0 < masks.mean() < 1
        k += len(bs)


def test_step_counts_and_spans(tiny_batch):
    *_, counts, prof = tiny_batch
    assert counts == {"sam_frames": 3, "sam_boxes": 4}
    names = [e.name for e in prof.events() if e.name.startswith("nsof.")]
    assert names.count("nsof.sam_gt_batch") == 1
    assert names.count("nsof.sam.encode.window") == 2 and names.count("nsof.sam.encode.global") == 1
    for part in ("preprocess", "encode", "decode", "postprocess"):
        assert names.count(f"nsof.sam.{part}") == 1, part


def test_no_box_at_all_gives_empty_masks():
    model = _tiny_model()
    frames = torch.zeros((2, 40, 30, 3), dtype=torch.uint8)
    out = tgt.sam_gt_batch(model, frames, torch.zeros((0, 4)), torch.zeros(0, dtype=torch.int64))
    assert out["mask"].shape == (2, 40, 30) and not out["mask"].any()
    assert out["low_res"].shape == (0, 1, 32, 32) and out["iou"].shape == (0, 1)


CUT = {"arch": "sam", "encoder_embed_dim": 1280, "encoder_depth": 2, "encoder_num_heads": 16,
       "encoder_global_attn_indexes": [1], "window_size": 14, "image_size": 480,
       "vit_patch_size": 16, "mlp_ratio": 4, "qkv_bias": True, "use_rel_pos": True,
       "prompt_embed_dim": 256, "mask_in_chans": 16, "decoder_depth": 2,
       "decoder_mlp_dim": 2048, "decoder_num_heads": 8, "num_multimask_outputs": 3,
       "iou_head_depth": 3, "iou_head_hidden_dim": 256, "multimask_output": False}


def test_port_matches_the_reference_at_vit_h_widths():
    cfg = ts.SamConfig(embed_dim=1280, depth=2, num_heads=16, global_attn_indexes=(1,),
                       img_size=480)
    state = ref_sam.synthetic_state(2**33 + 26, CUT)
    model = ts.pretrained_sam(dict(state), cfg, "cpu").eval().requires_grad_(False)
    rng = np.random.default_rng(26)
    frames = torch.from_numpy(rng.integers(0, 256, (1, 600, 338, 3), dtype=np.uint8))
    boxes = torch.tensor([[10.0, 20.0, 240.0, 400.0], [120.0, 300.0, 330.0, 580.0]])
    owner = torch.zeros(2, dtype=torch.int64)
    got = tgt.sam_gt_batch(model, frames, boxes, owner)
    want = ref_sam.sam_gt(frames, boxes, owner, CUT, state)
    top = want["low_res"].abs().max()
    assert (got["low_res"] - want["low_res"]).abs().max() <= 1e-4 * top
    assert (got["iou"] - want["iou"]).abs().max() <= 1e-4 * want["iou"].abs().max()
    assert (got["mask"] != want["mask"]).float().mean() <= 1e-3
    assert 0 < float(want["mask"].float().mean()) < 1
