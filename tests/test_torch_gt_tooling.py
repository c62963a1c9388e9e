"""The port's ground-truth tooling (``nsof_tpu_torch/data/gt_tooling.py``, its
``data/imgproc.py::resize_cubic`` and the shared resize weights
``ops/resize.py``) against the JAX package and OpenCV, on the CPU.

- ``resize_cubic`` against ``cv2.resize(INTER_CUBIC)`` (OpenCV 5 here),
  growing and shrinking, gray and RGB, and OWL-ViT's 480×640 → 768²: at
  most one level apart on at most 1e-6 of the values (measured: equal on
  these cases and on 28.9 M values of random sizes; one value one level off
  in 21.9 M of another draw, an exact value 137.4999947 that OpenCV's float
  sums round up; ROADMAP queue 3).  Other channel counts raise.
- ``ops/resize.py``'s weight matrices against ``jax.image.resize`` of an
  identity (its weights), linear both ways, Keys' cubic both ways and
  Lanczos-3, within 1e-6; a 2-D ``resize`` against ``jax.image.resize``
  within 1e-6 of the largest value.  ``compress_frames`` stays equal to its
  earlier arithmetic bit for bit (``tests/test_torch_device.py``).
- ``BrightnessBoxProposer`` equal to the JAX one (OpenCV's labelling).
- ``TorchOwlVitBoxProposer`` against ``FlaxOwlVitBoxProposer``, both
  ``from_params`` of one seeded Hugging Face-format state dict at
  ``TINY_OWLVIT`` (the Flax tree by ``convert_owlvit``) with the toy
  tokenizer: boxes within 1e-3 px, at a threshold that keeps every patch and
  at one between two scores.
- ``TorchSamSegmenter`` against ``FlaxSamSegmenter`` at ``TINY_SAM`` (the
  mask head scaled as ``tests/test_torch_sam.py``'s ``mixed_state``) with a
  brightness box proposer: masks ≥ 99.9 % equal; no boxes, no masks.
- ``generate_gt_masks`` on a folder of PNG frames: with the brightness
  segmenters the written masks equal the JAX function's and its instance
  counts; with the SAM chains ≥ 99.9 % equal.  On JPEG frames the masks
  keep the frames' names, and ``load_scene`` reads them back as the scene's
  ground truth, equal to the segmenter's masks.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsof_tpu.data import gt_tooling as jgt
from nsof_tpu.models import owlvit as jo
from nsof_tpu.models import sam as js
from nsof_tpu_torch.data import gt_tooling as tgt
from nsof_tpu_torch.data.imgproc import resize_cubic
from nsof_tpu_torch.models import owlvit as to
from nsof_tpu_torch.models import sam as ts
from nsof_tpu_torch.ops import resize as tresize
from nsof_tpu_torch.utils.png import decode_png, encode_png
from test_torch_sam import mixed_state
from torch_single_thread import one_torch_thread  # noqa: F401  (autouse)

CUBIC_CASES = {
    "rgb_owlvit_768": ((480, 640, 3), (768, 768)),
    "gray_grow": ((48, 64), (200, 150)),
    "rgb_grow": ((31, 37, 3), (64, 64)),
    "gray_shrink": ((97, 131), (50, 40)),
    "rgb_shrink": ((60, 80, 3), (33, 27)),
}
CUBIC_OFF_SHARE = 1e-6


@pytest.mark.parametrize("case", sorted(CUBIC_CASES))
def test_resize_cubic_matches_opencv(case):
    shape, (nw, nh) = CUBIC_CASES[case]
    img = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    got = resize_cubic(img, nw, nh)
    ref = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_CUBIC)
    assert got.shape == ref.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int64) - ref)
    assert diff.max() <= 1 and (diff > 0).mean() <= CUBIC_OFF_SHARE
    with pytest.raises(ValueError, match="uint8"):
        resize_cubic(np.zeros((4, 4, 2), np.uint8), 8, 8)


WEIGHT_CASES = [("linear", 96, 200), ("linear", 96, 60), ("linear", 256, 1024),
                ("cubic", 8, 12), ("cubic", 8, 6), ("lanczos3", 480, 6)]
JAX_METHOD = {"linear": "linear", "cubic": "bicubic", "lanczos3": "lanczos3"}


@pytest.mark.parametrize("kernel,n_in,n_out", WEIGHT_CASES)
def test_resize_weights_match_jax(kernel, n_in, n_out):
    want = jax.image.resize(jnp.eye(n_in), (n_in, n_out), JAX_METHOD[kernel])
    got = tresize.weight_mat(n_in, n_out, kernel, "cpu")
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-6


@pytest.mark.parametrize("kernel", ["linear", "cubic"])
def test_resize_2d_matches_jax(kernel):
    x = np.random.default_rng(1).normal(0, 1, (2, 96, 128)).astype(np.float32)
    for hw in ((60, 80), (200, 256)):
        want = np.asarray(jax.image.resize(jnp.asarray(x), (2,) + hw, JAX_METHOD[kernel]))
        got = tresize.resize(torch.from_numpy(x), hw, kernel).numpy()
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def _earlier_lanczos3_weights(in_size, out_size):
    """``device/frame_sim.py::_weight_mat`` as it stood before the weights
    moved to ``ops/resize.py``, verbatim."""
    import math

    def lanczos3(x):
        y = 3.0 * torch.sin(math.pi * x) * torch.sin(math.pi * x / 3.0)
        den = torch.where(x != 0, math.pi**2 * (x * x), 1.0)
        out = torch.where(x > 1e-3, y / den, 1.0)
        return torch.where(x > 3.0, 0.0, out)

    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    f32 = torch.float32
    sample_f = (torch.arange(out_size, dtype=f32) + 0.5) * inv_scale - 0.0 - 0.5
    x = torch.abs(sample_f[None, :] - torch.arange(in_size, dtype=f32)[:, None])
    weights = lanczos3(x / torch.tensor(kernel_scale, dtype=f32))
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(torch.abs(total) > 1000.0 * float(torch.finfo(f32).eps),
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


def test_compress_frames_unchanged():
    """``compress_frames`` equals, bit for bit, the two products with the
    weights it used before they moved (non-integer scales included)."""
    from nsof_tpu_torch.device.frame_sim import compress_frames

    frames = np.random.default_rng(9).random((3, 97, 130)).astype(np.float32)
    for m, n in ((20, 20), (7, 3), (13, 40)):
        h, w = frames.shape[1:]
        wy, wx = _earlier_lanczos3_weights(h, h // n), _earlier_lanczos3_weights(w, w // m)
        assert torch.equal(tresize.weight_mat(h, h // n, "lanczos3", "cpu", False), wy)
        want = torch.matmul(torch.matmul(wy.T, torch.from_numpy(frames)), wx)
        assert torch.equal(compress_frames(frames, m, n, device="cpu"), want)


def _blob_frame(rng, h=60, w=80):
    img = rng.integers(0, 120, (h, w, 3), dtype=np.uint8)
    img[8:30, 10:34] = 250
    img[36:55, 45:75] = 230
    return img


def test_brightness_box_proposer_matches_jax():
    rng = np.random.default_rng(2)
    for _ in range(4):
        img = _blob_frame(rng)
        for prompt in ("bright blobs", "dark blobs"):
            for thresh, area in ((180, 100), (150, 20)):
                got = tgt.BrightnessBoxProposer(thresh, area)(img, prompt)
                assert got == jgt.BrightnessBoxProposer(thresh, area)(img, prompt)


@pytest.fixture(scope="module")
def owl_pair():
    cfg = to.TINY_OWLVIT
    state = to.synthetic_owlvit_state_dict(cfg, seed=5)
    _, params = jo.convert_owlvit(state, jo.TINY_OWLVIT)
    tok = tgt.toy_tokenizer(cfg.vocab_size, cfg.max_text_len)
    jprop = jgt.FlaxOwlVitBoxProposer.from_params(jo.TINY_OWLVIT, params,
                                                  lambda t: tok(t).astype(np.int32))
    tprop = tgt.TorchOwlVitBoxProposer.from_params(cfg, state, tok, device="cpu")
    return jprop, tprop


def test_owlvit_proposer_matches_jax(owl_pair):
    jprop, tprop = owl_pair
    img = _blob_frame(np.random.default_rng(3), 48, 64)
    for prompt in ("bright blob", "moving object"):
        jprop.score_threshold = tprop.score_threshold = -1.0  # every patch
        want = np.asarray(jprop(img, prompt))
        got = np.asarray(tprop(img, prompt))
        assert got.shape == want.shape == (16, 4)
        assert np.abs(got - want).max() <= 1e-3
        assert (got[:, 2] <= 64).all() and (got[:, 3] <= 48).all() and (got >= 0).all()
        # a threshold between two scores keeps the same patches
        ids = tprop.tokenizer(prompt).reshape(1, 1, -1)
        with torch.no_grad():
            logits = tprop.model(tprop.pixels(img), torch.from_numpy(ids))["logits"]
        scores = np.sort(torch.sigmoid(logits[0].max(-1).values).numpy())
        jprop.score_threshold = tprop.score_threshold = float(scores[7:9].mean())
        want, got = np.asarray(jprop(img, prompt)), np.asarray(tprop(img, prompt))
        assert got.shape == want.shape == (8, 4)
        assert np.abs(got - want).max() <= 1e-3


@pytest.fixture(scope="module")
def sam_pair():
    state = mixed_state(js.synthetic_sam_state_dict(js.TINY_SAM, seed=7))
    _, params = js.convert_sam(state, js.TINY_SAM)
    model = ts.Sam(ts.TINY_SAM)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return (jgt.FlaxSamSegmenter(js.TINY_SAM, params, jgt.BrightnessBoxProposer(200, 50)),
            tgt.TorchSamSegmenter(model, tgt.BrightnessBoxProposer(200, 50), device="cpu"))


def test_sam_segmenter_matches_jax(sam_pair):
    jseg, tseg = sam_pair
    img = _blob_frame(np.random.default_rng(4))
    want, got = jseg(img, "bright"), tseg(img, "bright")
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == bool and g.shape == w.shape == (60, 80)
        assert (g == w).mean() >= 0.999
    flat = np.full((60, 80, 3), 128, np.uint8)  # no box, no mask
    assert tseg(flat, "bright") == [] and jseg(flat, "bright") == []


def _png_folder(root, n=3):
    rng = np.random.default_rng(6)
    names = []
    for i in range(n):
        img = _blob_frame(rng)
        img[:, : 4 * i] = 0
        names.append(f"{i:03d}.png")
        (root / names[-1]).write_bytes(encode_png(img))
    (root / "imgs.txt").write_text("\n".join(names) + "\n\n")
    return names


@pytest.mark.parametrize("chain", ["brightness", "sam"])
def test_generate_gt_masks_matches_jax(tmp_path, sam_pair, chain):
    frames = tmp_path / "RGB"
    frames.mkdir()
    names = _png_folder(frames)
    jseg, tseg = ((jgt.BrightnessSegmenter(200, 50), tgt.BrightnessSegmenter(200, 50))
                  if chain == "brightness" else sam_pair)
    want = jgt.generate_gt_masks(frames, frames / "imgs.txt", tmp_path / "jax", "bright", jseg)
    got = tgt.generate_gt_masks(frames, frames / "imgs.txt", tmp_path / "port", "bright", tseg)
    assert [r.frame for r in got] == [r.frame for r in want] == names
    for g, w in zip(got, want):
        assert g.n_instances == w.n_instances
        mask = decode_png((tmp_path / "port" / g.frame).read_bytes(), gray=True)
        assert g.mask_path == str(tmp_path / "port" / g.frame)
        ref = cv2.imread(w.mask_path, cv2.IMREAD_GRAYSCALE)
        assert set(np.unique(mask)) <= {0, 255} and mask.shape == ref.shape
        if chain == "brightness":
            np.testing.assert_array_equal(mask, ref)
        else:
            assert (mask == ref).mean() >= 0.999 and mask.any()


def test_generate_gt_masks_feeds_load_scene(tmp_path, sam_pair):
    """Masks made for JPEG frames land where the scene loader looks for
    them (``gtmask/<frame name>``) and load as the scene's ground truth.
    Taken ``batch`` frames at a time (SAM's one batched step a group, the
    brightness segmenter frame by frame), the written PNGs are the same
    bytes as one frame at a time."""
    import scipy.io

    from nsof_tpu_torch.data.scenes import load_scene

    scene = tmp_path / "tabletennis"
    (scene / "RGB").mkdir(parents=True)
    rng = np.random.default_rng(8)
    names = [f"{i:04d}.jpg" for i in range(3)]
    for name in names:
        cv2.imwrite(str(scene / "RGB" / name), _blob_frame(rng)[..., ::-1])
    (scene / "imgs.txt").write_text("\n".join(names) + "\n")
    scipy.io.savemat(str(scene / "constructed_3D_matrix.mat"),
                     {"constructed3DMatrix": np.zeros((6, 8, 16))})
    seg = tgt.BrightnessSegmenter(200, 50)
    got = tgt.generate_gt_masks(scene / "RGB", scene / "imgs.txt", scene / "gtmask", "bright", seg)
    assert [r.mask_path for r in got] == [str(scene / "gtmask" / n) for n in names]
    loaded = load_scene(tmp_path, "tabletennis")
    assert loaded.gt_masks is not None and loaded.gt_masks.shape == (3, 60, 80)
    for name, gt, r in zip(names, loaded.gt_masks, got):
        rgb = cv2.cvtColor(cv2.imread(str(scene / "RGB" / name)), cv2.COLOR_BGR2RGB)
        want = np.logical_or.reduce(seg(rgb, "bright"))
        assert r.n_instances == 2
        np.testing.assert_array_equal(gt > 0, want)
    for kind, chain in (("brightness", seg), ("sam", sam_pair[1])):
        written = {}
        for batch in (1, 2, 3):
            out = tmp_path / f"{kind}{batch}"
            res = tgt.generate_gt_masks(scene / "RGB", scene / "imgs.txt", out, "bright", chain,
                                        batch=batch)
            assert [(r.frame, r.n_instances) for r in res] == [(n, 2) for n in names]
            written[batch] = [(out / n).read_bytes() for n in names]
        assert written[1] == written[2] == written[3], kind
