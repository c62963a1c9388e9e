"""The port's training data layer (``nsof_tpu_torch/data/flow_datasets.py``,
``nsof_tpu_torch/data/imgproc.py``, the stage tables and iterators of
``nsof_tpu_torch/train/curriculum.py``) against the JAX package's, which
calls OpenCV.

Same seed, same draws: every function takes from its ``rng`` what the JAX
function takes, in the same order, so after ``augment_pair``,
``synthetic_affine_dataset``, ``batch_iterator`` and
``mixed_batch_iterator`` both generators give the same next
``rng.random()``.  Then:

- flows: dense within 1e-4 px (measured equal), sparse exactly, valid masks
  equal;
- uint8 images within one level, on ≤ 0.1 % of the values (measured ≤
  3e-5 of them, where OpenCV's vectorised loops round or fuse differently:
  its HSV → RGB truncates in blocks of 32 pixels and rounds the rest of a
  row, its Gaussian blur sums in another order).

The numpy versions of the OpenCV calls, on their own against OpenCV
(``cv2.resize`` INTER_LINEAR on uint8 and float32 up and down, RGB ↔ HSV
over every uint8 colour, ``GaussianBlur(σ = 2)``, ``warpAffine`` of a
translation): resize exact (measured), RGB → HSV exact, HSV → RGB within
one level on ≤ 1e-4 of the values (measured 4.6e-5: OpenCV's vectorised
truncation of 255·v/255 at some multiples of 5), the blur within 1e-4 absolute (values in
[0, 255]), the warp within 2e-5.

Also ``build_stage_items`` (the same items, in the same order, with the
same augmentors) and the stage tables, field by field.
"""

import dataclasses

import numpy as np
import pytest

from nsof_tpu.data import flow_datasets as jfd
from nsof_tpu.train import curriculum as jcur
from nsof_tpu_torch.data import flow_datasets as tfd
from nsof_tpu_torch.data import imgproc
from nsof_tpu_torch.train import curriculum as tcur

cv2 = pytest.importorskip("cv2")

LEVEL_FRACTION = 1e-3
FLOW_TOL = 1e-4


def _close_u8(got, want, fraction=LEVEL_FRACTION):
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    assert d.max() <= 1 and (d > 0).mean() <= fraction, (d.max(), (d > 0).mean())


def _same_next_draw(rj, rt):
    assert rj.random() == rt.random()


# ── the OpenCV calls ─────────────────────────────────────────────────────

RESIZES = [((384, 512), (400, 530)), ((384, 512), (378, 504)), ((96, 128), (150, 200)),
           ((100, 120), (70, 90)), ((436, 1024), (500, 1100))]


@pytest.mark.parametrize("shape,size", RESIZES)
def test_resize_linear_equals_cv2(shape, size):
    rng = np.random.default_rng(1)
    nh, nw = size
    img = (rng.random(shape + (3,)) * 255).astype(np.uint8)
    want = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(imgproc.resize_linear(img, nw, nh), want)
    flow = (rng.normal(size=shape + (2,)) * 5).astype(np.float32)
    want = cv2.resize(flow, (nw, nh), interpolation=cv2.INTER_LINEAR)
    np.testing.assert_allclose(imgproc.resize_linear(flow, nw, nh), want, rtol=0, atol=1e-5)
    mask = (rng.random(shape) > 0.5).astype(np.uint8)
    np.testing.assert_array_equal(imgproc.resize_linear(mask, nw, nh),
                                  cv2.resize(mask, (nw, nh)))


def test_hsv_every_colour_against_cv2():
    g, b = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    for r in range(256):  # 256 images of 256×256: every colour
        rgb = np.stack([np.full_like(g, r), g, b], -1).astype(np.uint8)
        np.testing.assert_array_equal(imgproc.rgb_to_hsv_u8(rgb),
                                      cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV))
    s, v = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    off = total = 0
    for h in range(180):
        hsv = np.stack([np.full_like(s, h), s, v], -1).astype(np.uint8)
        # rows of whole 32-pixel blocks (256 wide), and with a scalar tail (250)
        for img in (hsv, hsv[:, :250]):
            d = np.abs(imgproc.hsv_to_rgb_u8(img).astype(np.int64)
                       - cv2.cvtColor(img, cv2.COLOR_HSV2RGB))
            assert d.max() <= 1
            off, total = off + int((d > 0).sum()), total + d.size
    assert off <= 1e-4 * total, off / total


def test_blur_and_warp_against_cv2():
    rng = np.random.default_rng(2)
    base = (rng.random((128, 160, 3)) * 255).astype(np.float32)
    blur = imgproc.gaussian_blur(base, 2.0)
    np.testing.assert_allclose(blur, cv2.GaussianBlur(base, (0, 0), 2.0), rtol=0, atol=1e-4)
    for dx, dy in ((1.3, -2.7), (-5.99, 4.01), (0.5, 0.0), (3.0, -3.0)):
        m = np.float32([[1, 0, -dx], [0, 1, -dy]])
        want = cv2.warpAffine(blur, m, (160, 128))[16:-16, 16:-16]
        got = imgproc.warp_translate(blur, float(np.float32(dx)), float(np.float32(dy)))
        np.testing.assert_allclose(got[16:-16, 16:-16], want, rtol=0, atol=2e-5)


# ── the data functions under one seed ────────────────────────────────────


def test_synthetic_affine_dataset_matches_jax():
    rj, rt = np.random.default_rng(3), np.random.default_rng(3)
    want = jfd.synthetic_affine_dataset(rj, n=4, size=(64, 96), max_shift=5.0)
    got = tfd.synthetic_affine_dataset(rt, n=4, size=(64, 96), max_shift=5.0)
    _same_next_draw(rj, rt)
    for (a1, a2, af), (b1, b2, bf) in zip(got, want):
        _close_u8(a1, b1)
        _close_u8(a2, b2)
        np.testing.assert_array_equal(af, bf)


@pytest.fixture(scope="module")
def samples():
    """Four 384×512 synthetic pairs (FlyingChairs' size) and a sparse
    validity mask."""
    data = jfd.synthetic_affine_dataset(np.random.default_rng(0), n=4, size=(384, 512))
    valid = np.random.default_rng(1).random((384, 512)) > 0.6
    return data, valid


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("sparse", [False, True])
def test_augment_pair_matches_jax(samples, seed, sparse):
    data, valid = samples
    i1, i2, fl = data[seed % 4]
    kw = dict(crop_size=(368, 496), min_scale=-0.1, max_scale=1.0, sparse=sparse,
              do_flip=seed % 3 != 0)
    v = valid if sparse else None
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    want = jfd.augment_pair(rj, i1, i2, fl, jfd.AugmentorConfig(**kw), v)
    got = tfd.augment_pair(rt, i1, i2, fl, tfd.AugmentorConfig(**kw), v)
    _same_next_draw(rj, rt)
    _close_u8(got[0], want[0])
    _close_u8(got[1], want[1])
    if sparse:
        np.testing.assert_array_equal(got[2], want[2])
    else:
        np.testing.assert_allclose(got[2], want[2], rtol=0, atol=FLOW_TOL)
    np.testing.assert_array_equal(got[3], want[3])
    assert got[2].shape == (368, 496, 2) and got[3].dtype == bool


def test_augmentor_configs_equal():
    assert dataclasses.asdict(tfd.AugmentorConfig()) == dataclasses.asdict(jfd.AugmentorConfig())


def _batches_close(got, want):
    assert sorted(got) == sorted(want)
    _close_u8(got["image1"].astype(np.uint8), want["image1"].astype(np.uint8))
    _close_u8(got["image2"].astype(np.uint8), want["image2"].astype(np.uint8))
    assert got["image1"].dtype == want["image1"].dtype == np.float32
    np.testing.assert_allclose(got["flow"], want["flow"], rtol=0, atol=FLOW_TOL)
    np.testing.assert_array_equal(got["valid"], want["valid"])


def test_batch_iterators_match_jax(samples):
    data = [(a[:96, :128], b[:96, :128], f[:96, :128]) for a, b, f in samples[0]]
    for aug in (None, (80, 112)):
        rj, rt = np.random.default_rng(4), np.random.default_rng(4)
        jaug = None if aug is None else jfd.AugmentorConfig(crop_size=aug)
        taug = None if aug is None else tfd.AugmentorConfig(crop_size=aug)
        want = list(jfd.batch_iterator(data, 2, rj, jaug, epochs=2))
        got = list(tfd.batch_iterator(data, 2, rt, taug, epochs=2))
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            _batches_close(g, w)
        _same_next_draw(rj, rt)


def _stage(mod):
    return mod.StageSpec(
        name="mix",
        sources=(mod.SourceSpec("a", 2, -0.2, 0.6, True),
                 mod.SourceSpec("b", 3, -0.5, 0.2, False, sparse=True)),
        num_steps=10, batch_size=2, lr=1e-4, image_size=(80, 112), wdecay=1e-4)


def test_stage_items_and_mixed_batches_match_jax(samples):
    data = [(a[:96, :128], b[:96, :128], f[:96, :128]) for a, b, f in samples[0]]
    scanners = {"a": lambda: data[:3], "b": lambda: data[3:]}
    jitems = jcur.build_stage_items(_stage(jcur), scanners)
    titems = tcur.build_stage_items(_stage(tcur), scanners)
    assert len(titems) == len(jitems) == 3 * 2 + 1 * 3
    for (tp, ta), (jp, ja) in zip(titems, jitems):
        assert tp is jp
        assert dataclasses.asdict(ta) == dataclasses.asdict(ja)
    rj, rt = np.random.default_rng(5), np.random.default_rng(5)
    want = list(jcur.mixed_batch_iterator(jitems, 2, rj, epochs=2))
    got = list(tcur.mixed_batch_iterator(titems, 2, rt, epochs=2))
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        _batches_close(g, w)
    _same_next_draw(rj, rt)
    with pytest.raises(KeyError):
        tcur.build_stage_items(_stage(tcur), {"a": lambda: data})


@pytest.mark.parametrize("table", ["RAFT_STANDARD_STAGES", "FLOWFORMER_STAGES"])
def test_stage_tables_equal(table):
    want, got = getattr(jcur, table), getattr(tcur, table)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert dataclasses.asdict(g) == dataclasses.asdict(w)
        for src in g.sources:
            assert dataclasses.asdict(src.augmentor(g.image_size)) == dataclasses.asdict(
                jcur.SourceSpec(**dataclasses.asdict(src)).augmentor(g.image_size))
