"""The port's YOLOv8 (``nsof_tpu_torch/models/yolov8.py``) against the JAX
package's, on the CPU, from the same seeded numpy inputs.

- ``YoloConfig``: every scale's widths and repeats equal the JAX package's.
- Weights: ``synthetic_state_dict`` equals the JAX fixture for a seed (keys,
  shapes, values); the port's ``convert_yolov8`` equals
  ``params_from_jax`` of the JAX converter's Flax tree bit for bit; a bad DFL
  raises ``ValueError``, a missing tensor ``KeyError``.
- The forward: YOLOv8n at 96×128 and YOLOv8s at 64×64 against Flax
  ``YOLOv8.apply`` on the same weights, within 2e-4 (``tests/test_yolo.py``'s
  bound for the Flax model against its torch transliteration).
- ``decode_predictions`` on the same raw outputs within 1e-4 px and 1e-6 of
  a score (the DFL expectation sums its 16 bins in another order), and the
  one-hot DFL case; ``postprocess`` equal to the JAX one on the same
  decoded inputs: the class-aware case of ``tests/test_yolo.py``, exact
  ties, more candidates than ``max_det``, and none.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsof_tpu.models import yolov8 as jy
from nsof_tpu_torch.models import yolov8 as ty
from torch_single_thread import one_torch_thread  # noqa: F401  (autouse)

SCALES = ("n", "s", "m", "l", "x")
# the JAX side jitted (one compile a shape), as JaxYoloDetector runs it
jax_decode = jax.jit(jy.decode_predictions, static_argnums=(1, 2))
jax_postprocess = jax.jit(jy.postprocess, static_argnums=(2, 3, 4))


@pytest.mark.parametrize("scale", SCALES)
def test_config_matches_jax(scale):
    j, t = jy.YoloConfig(scale), ty.YoloConfig(scale)
    assert t.backbone_channels == j.backbone_channels
    assert (t.n_rep(3), t.n_rep(6)) == (j.n_rep(3), j.n_rep(6))
    assert (t.depth, t.width, t.max_channels) == (j.depth, j.width, j.max_channels)
    assert ty.SCALES == jy.SCALES and ty.STRIDES == jy.STRIDES
    assert (ty.REG_MAX, ty.BN_EPS) == (jy.REG_MAX, jy.BN_EPS)


@pytest.mark.parametrize("scale,seed", [("n", 3), ("s", 0)])
def test_synthetic_state_dict_matches_jax(scale, seed):
    got = ty.synthetic_state_dict(ty.YoloConfig(scale), seed=seed)
    ref = jy.synthetic_state_dict(jy.YoloConfig(scale), seed=seed)
    assert list(got) == list(ref)
    for k, v in ref.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.fixture(scope="module")
def weights_n():
    state = jy.synthetic_state_dict(jy.YoloConfig("n"), seed=3)
    return state, jy.convert_yolov8(state, jy.YoloConfig("n"))


@pytest.mark.parametrize("prefix", ["model.", ""])
def test_convert_matches_params_from_jax(weights_n, prefix):
    state, params = weights_n
    if not prefix:
        state = {k[len("model."):]: v for k, v in state.items()}
    got = ty.convert_yolov8(state, ty.YoloConfig("n"))
    ref = ty.params_from_jax(params, ty.YoloConfig("n"))
    assert set(got) == set(ref) == set(ty.YOLOv8(ty.YoloConfig("n")).state_dict())
    for k, v in ref.items():
        assert got[k].dtype == v.dtype == torch.float32
        assert torch.equal(got[k], v), k


def test_convert_refuses_bad_dfl_and_missing_tensors(weights_n):
    state, params = weights_n
    bad = dict(state)
    bad["model.22.dfl.conv.weight"] = np.ones((1, ty.REG_MAX, 1, 1), np.float32)
    with pytest.raises(ValueError, match="DFL"):
        ty.convert_yolov8(bad, ty.YoloConfig("n"))
    missing = {k: v for k, v in state.items() if k != "model.15.m.0.cv2.bn.running_var"}
    with pytest.raises(KeyError):
        ty.convert_yolov8(missing, ty.YoloConfig("n"))
    tree = {k: dict(v) for k, v in params["params"].items()}
    del tree["l19"]
    with pytest.raises(ValueError, match="l19.conv.weight: no Flax source"):
        ty.params_from_jax({"params": tree}, ty.YoloConfig("n"))


def _forward_pair(scale, seed, shape):
    cfg = jy.YoloConfig(scale)
    state = jy.synthetic_state_dict(cfg, seed=seed)
    params = jy.convert_yolov8(state, cfg)
    x = np.random.default_rng(seed).random((1, *shape, 3)).astype(np.float32)
    ref = jax.jit(jy.YOLOv8(cfg).apply)(params, jnp.asarray(x))
    model = ty.YOLOv8(ty.YoloConfig(scale))
    model.load_state_dict(ty.params_from_jax(params, ty.YoloConfig(scale)))
    with torch.no_grad():
        got = model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    return got, [np.asarray(r) for r in ref]


@pytest.mark.parametrize("scale,seed,shape", [("n", 3, (96, 128)), ("s", 1, (64, 64))])
def test_forward_matches_flax(scale, seed, shape):
    got, ref = _forward_pair(scale, seed, shape)
    assert len(got) == len(ref) == 3
    for g, r, s in zip(got, ref, ty.STRIDES):
        g = g.numpy().transpose(0, 2, 3, 1)
        assert g.shape == r.shape == (1, shape[0] // s, shape[1] // s, 4 * ty.REG_MAX + 80)
        np.testing.assert_allclose(g, r, rtol=2e-4, atol=2e-4)


def test_decode_matches_jax():
    rng = np.random.default_rng(5)
    raw = [rng.normal(0, 3, (2, 4 * ty.REG_MAX + 80, h, w)).astype(np.float32)
           for h, w in ((12, 16), (6, 8), (3, 4))]
    jb, js = jax_decode(tuple(jnp.asarray(r.transpose(0, 2, 3, 1)) for r in raw), 80)
    tb, ts = ty.decode_predictions([torch.from_numpy(r) for r in raw], 80)
    assert tb.shape == jb.shape == (2, 12 * 16 + 6 * 8 + 3 * 4, 4)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)


def test_decode_dfl_expectation():
    """One-hot DFL bin k → decoded distance k from the anchor centre."""
    raw = np.full((1, 4 * ty.REG_MAX + 80, 2, 2), -40.0, np.float32)
    for side, k in enumerate((2, 1, 3, 0)):  # cell (0, 0): l=2, t=1, r=3, b=0
        raw[0, side * ty.REG_MAX + k, 0, 0] = 40.0
    boxes, scores = ty.decode_predictions([torch.from_numpy(raw)], 80, strides=(8,))
    np.testing.assert_allclose(boxes[0, 0].numpy(), [-12.0, -4.0, 28.0, 4.0], atol=1e-3)
    jb, _ = jax_decode((jnp.asarray(raw.transpose(0, 2, 3, 1)),), 80, (8,))
    np.testing.assert_allclose(boxes.numpy(), np.asarray(jb), rtol=0, atol=1e-4)
    assert scores.shape == (1, 4, 80)


def _overlapping(rng, b, n, nc, levels=None):
    """``[b, n, 4]`` boxes clustered on a few centres (many overlaps) and
    ``[b, n, nc]`` scores; ``levels`` quantises the scores (exact ties)."""
    centres = rng.uniform(20, 140, (b, 6, 2))
    pick = centres[np.arange(b)[:, None], rng.integers(0, 6, (b, n))]
    wh = rng.uniform(8, 40, (b, n, 2))
    xy = pick + rng.normal(0, 4, (b, n, 2))
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], -1).astype(np.float32)
    scores = rng.random((b, n, nc)).astype(np.float32) ** 3
    if levels:
        scores = (np.round(scores * levels) / levels).astype(np.float32)
    return boxes, scores


def _class_aware_case():
    boxes = np.asarray([[[0, 0, 10, 10], [1, 1, 11, 11], [0, 0, 10, 10],
                         [50, 50, 60, 60]]], np.float32)
    scores = np.zeros((1, 4, 3), np.float32)
    scores[0, 0, 0], scores[0, 1, 0], scores[0, 2, 1], scores[0, 3, 2] = 0.9, 0.8, 0.7, 0.6
    return boxes, scores, 4


# every case but the first at one shape (one compile of the JAX side):
# B = 2, N = 400 candidates of 2 classes, max_det 300
POST_CASES = {
    "class_aware": _class_aware_case,
    "random_overlaps": lambda: (*_overlapping(np.random.default_rng(0), 2, 400, 2), 300),
    "exact_ties": lambda: (*_overlapping(np.random.default_rng(1), 2, 400, 2, levels=4), 300),
    "more_than_max_det": lambda: _more_than_max_det(np.random.default_rng(2)),
    "none": lambda: (_overlapping(np.random.default_rng(3), 2, 400, 2)[0],
                     np.full((2, 400, 2), 0.1, np.float32), 300),
}


def _more_than_max_det(rng):
    """Every one of the 400 boxes a candidate, disjoint in pairs of
    classes, so more than max_det would survive NMS."""
    boxes, scores = _overlapping(rng, 2, 400, 2)
    scores = np.maximum(scores, 0.3).astype(np.float32)
    return boxes, scores, 300


@pytest.mark.parametrize("name", sorted(POST_CASES))
def test_postprocess_equals_jax(name):
    boxes, scores, max_det = POST_CASES[name]()
    ref = jax_postprocess(jnp.asarray(boxes), jnp.asarray(scores), 0.25, 0.45, max_det)
    got = ty.postprocess(torch.from_numpy(boxes), torch.from_numpy(scores), 0.25, 0.45, max_det)
    assert set(got) == set(ref)
    for k in ref:
        r = np.asarray(ref[k])
        assert got[k].shape == r.shape, k
        np.testing.assert_array_equal(got[k].numpy(), r, err_msg=k)
    if name == "class_aware":
        assert got["valid"][0].sum() == 3
    if name == "none":
        assert not got["valid"].any()
    else:
        assert got["valid"].sum() > 0
