"""The port's SAM (``nsof_tpu_torch/models/sam.py``) against the JAX
package's Flax SAM, on the CPU, at ``TINY_SAM`` from the same seeded numpy
weights (``synthetic_sam_state_dict``, seed 7) and inputs.

- Weights: the port's ``synthetic_sam_state_dict`` equals the JAX one;
  ``params_from_jax`` of ``convert_sam``'s Flax tree gives back the official
  state dict bit for bit, and it loads strictly; ``infer_sam_config`` on
  vit_b/l/h widths; ``pretrained_sam`` reads a ``torch.save`` checkpoint
  (plain, and wrapped with ``module.`` prefixes) by its own keys.
- The encoder (windowed blocks 0 and 2, global block 1), at window 4 and
  at window 3 (the 8×8 tokens padded to 9×9), within 1e-4 of the output's
  largest magnitude (float32, other sum orders; measured ≤ 1e-6).
- The resizes the JAX encoder makes at another size, held against it
  directly (the Flax encoder refuses another input size: its global
  blocks' relative-position parameters take the input's shape): a
  relative-position table shrunk and stretched (``_rel_pos_table``), the
  position embedding by Keys' cubic (``jax.image.resize``, 'bicubic'),
  within 1e-6; the port's encoder then runs at 96² and 160².
- The prompt encoder (points only, with the padding point; boxes; points
  with boxes; a mask input) and the dense PE, within 1e-5; the decoder's
  masks and IoU (every mask token), within 1e-4 of the largest.
- ``SamPredictor`` (set_image → predict, box and point prompts, single and
  multimask) on a 60×80 frame (``postprocess`` shrinks 96×128 → 60×80) and
  a 200×150 frame (it stretches), the low-res logits, IoU and upsampled
  logits within 1e-4 of the largest magnitude.  The seeded weights give
  logits of ≈ 3e-3, all positive on these frames, so the masks themselves
  are compared on weights with the last upscaling convolution and the
  hypernetworks' last layers ×20 (``mixed_state``: 44 % of the pixels
  true), ≥ 99.9 % equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsof_tpu.models import sam as js
from nsof_tpu_torch.models import sam as ts
from torch_single_thread import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-4  # of the largest magnitude: float32 in other orders
SEED = 7


def _tiny(window):
    return (ts.TINY_SAM if window == 4 else
            ts.SamConfig(**{**ts.TINY_SAM.__dict__, "window_size": window}))


def _jcfg(cfg):
    return js.SamConfig(**cfg.__dict__)


def mixed_state(state):
    """``state`` with the mask head scaled so that the frame decides the sign
    of the logits (see the module docstring)."""
    out = dict(state)
    out["mask_decoder.output_upscaling.3.weight"] = state[
        "mask_decoder.output_upscaling.3.weight"] * 20
    for i in range(ts.TINY_SAM.num_mask_tokens):
        k = f"mask_decoder.output_hypernetworks_mlps.{i}.layers.2.weight"
        out[k] = state[k] * 20
    return out


def _pair(state, cfg):
    """(Flax params, port model) of one state dict."""
    _, params = js.convert_sam(state, _jcfg(cfg))
    model = ts.Sam(cfg)
    model.load_state_dict(ts.params_from_jax(jax.tree.map(np.asarray, params), cfg))
    return params, model.eval()


@pytest.fixture(scope="module")
def tiny():
    state = js.synthetic_sam_state_dict(js.TINY_SAM, seed=SEED)
    return (state,) + _pair(state, ts.TINY_SAM)


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_synthetic_state_dict_matches_jax():
    got = ts.synthetic_sam_state_dict(ts.TINY_SAM, seed=SEED)
    ref = js.synthetic_sam_state_dict(js.TINY_SAM, seed=SEED)
    assert list(got) == list(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_params_from_jax_round_trip(tiny):
    state, params, _ = tiny
    back = ts.params_from_jax(jax.tree.map(np.asarray, params), ts.TINY_SAM)
    assert set(back) == set(state) == set(ts.Sam(ts.TINY_SAM).state_dict())
    for k, v in state.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    ts.Sam(ts.TINY_SAM).load_state_dict({k: torch.from_numpy(v) for k, v in state.items()},
                                        strict=True)
    broken = jax.tree.map(np.asarray, params)
    del broken["mask_decoder"]["params"]["iou_token"]
    with pytest.raises(ValueError, match="iou_token"):
        ts.params_from_jax(broken, ts.TINY_SAM)


@pytest.mark.parametrize("name", sorted(ts.SAM_CONFIGS))
def test_infer_config(name):
    cfg = ts.SAM_CONFIGS[name]
    assert all(getattr(cfg, k) == getattr(js.SAM_CONFIGS[name], k) for k in cfg.__dict__)
    fake = {"image_encoder.patch_embed.proj.weight": torch.zeros(cfg.embed_dim, 3, 16, 16)}
    assert ts.infer_sam_config(fake) is cfg
    with pytest.raises(ValueError, match="width"):
        ts.infer_sam_config({"image_encoder.patch_embed.proj.weight": torch.zeros(5, 3, 16, 16)})


def test_preprocess_shape():
    for hw in ((1080, 1920), (1024, 1024), (60, 80), (200, 150), (480, 640)):
        assert ts.preprocess_shape(*hw, 1024) == js.preprocess_shape(*hw, 1024)


@pytest.mark.parametrize("window", [4, 3])
def test_encoder_matches_jax(window):
    cfg = _tiny(window)
    state = js.synthetic_sam_state_dict(_jcfg(cfg), seed=SEED)
    params, model = _pair(state, cfg)
    img = np.random.default_rng(0).normal(0, 1, (1, 3, 128, 128)).astype(np.float32)
    enc = jax.jit(js.ImageEncoderViT(_jcfg(cfg)).apply)
    want = np.asarray(enc(params["image_encoder"], img.transpose(0, 2, 3, 1)))
    with torch.no_grad():
        got = model.image_encoder(torch.from_numpy(img)).numpy()
    assert rel_err(got.transpose(0, 2, 3, 1), want) <= TOL


@pytest.mark.parametrize("q", [6, 8, 10])
def test_rel_pos_table_matches_jax(q):
    table = np.random.default_rng(q).normal(0, 1, (15, 8)).astype(np.float32)
    want = np.asarray(js._rel_pos_table(jnp.asarray(table), q, q))
    got = ts.rel_pos_table(torch.from_numpy(table), q, q).numpy()
    assert np.abs(got - want).max() <= 1e-6


def test_pos_embed_resize_matches_jax(tiny):
    _, _, model = tiny
    from nsof_tpu_torch.ops.resize import resize_axis

    pos = model.image_encoder.pos_embed.detach()
    for s in (6, 10):
        want = np.asarray(jax.image.resize(jnp.asarray(pos.numpy()), (1, s, s, 32), "bicubic"))
        got = resize_axis(resize_axis(pos, 1, s, "cubic"), 2, s, "cubic").numpy()
        assert np.abs(got - want).max() <= 1e-6
        img = torch.from_numpy(np.random.default_rng(s).normal(0, 1, (1, 3, 16 * s, 16 * s))
                               .astype(np.float32))
        with torch.no_grad():
            out = model.image_encoder(img)
        assert out.shape == (1, 64, s, s) and torch.isfinite(out).all()


PROMPTS = {
    "points": (True, False, False),
    "boxes": (False, True, False),
    "points_boxes": (True, True, False),
    "mask": (False, True, True),
}


@pytest.mark.parametrize("case", sorted(PROMPTS))
def test_prompt_encoder_matches_jax(tiny, case):
    _, params, model = tiny
    points, boxes, mask = PROMPTS[case]
    rng = np.random.default_rng(1)
    coords = rng.uniform(0, 128, (2, 3, 2)).astype(np.float32) if points else None
    labels = np.array([[1, 0, -1], [1, 1, 0]], np.int32) if points else None
    bxs = np.array([[4, 6, 60, 80], [10, 10, 50, 50]], np.float32) if boxes else None
    m = rng.normal(0, 1, (2, 32, 32, 1)).astype(np.float32) if mask else None
    pe = js.PromptEncoder(js.TINY_SAM)
    sp, dn = jax.jit(pe.apply)(params["prompt_encoder"], *(
        None if a is None else jnp.asarray(a) for a in (coords, labels, bxs, m)))
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    with torch.no_grad():
        sp2, dn2 = model.prompt_encoder(t(coords), t(labels), t(bxs),
                                        None if m is None else t(m.transpose(0, 3, 1, 2).copy()))
    assert sp2.shape == sp.shape
    assert np.abs(sp2.detach().numpy() - np.asarray(sp)).max() <= 1e-5
    assert np.abs(dn2.detach().numpy().transpose(0, 2, 3, 1) - np.asarray(dn)).max() <= 1e-5
    want = pe.apply(params["prompt_encoder"], 8, 8, method=js.PromptEncoder.dense_pe)
    with torch.no_grad():
        got = model.prompt_encoder.get_dense_pe()[0].permute(1, 2, 0).numpy()
    assert np.abs(got - np.asarray(want)).max() <= 1e-5


def test_mask_decoder_matches_jax(tiny):
    _, params, model = tiny
    rng = np.random.default_rng(2)
    emb = rng.normal(0, 1, (1, 64, 8, 8)).astype(np.float32)
    boxes = np.array([[4, 6, 60, 80], [12, 20, 100, 90]], np.float32)
    pe = js.PromptEncoder(js.TINY_SAM)
    sp, dn = pe.apply(params["prompt_encoder"], None, None, jnp.asarray(boxes), None)
    dpe = pe.apply(params["prompt_encoder"], 8, 8, method=js.PromptEncoder.dense_pe)
    masks, iou = jax.jit(js.MaskDecoder(js.TINY_SAM).apply)(
        params["mask_decoder"], jnp.asarray(emb.transpose(0, 2, 3, 1)), dpe, sp, dn)
    with torch.no_grad():
        sp2, dn2 = model.prompt_encoder(None, None, torch.from_numpy(boxes), None)
        m2, i2 = model.mask_decoder(torch.from_numpy(emb), model.prompt_encoder.get_dense_pe(),
                                    sp2, dn2)
    assert rel_err(m2.numpy(), masks) <= TOL
    assert rel_err(i2.numpy(), iou) <= TOL


FRAMES = {"shrink_60x80": (60, 80), "stretch_200x150": (200, 150)}
PREDICTS = {
    "boxes": dict(boxes=np.array([[5, 6, 50, 40], [0, 0, 80, 60]], np.float32)),
    "points": dict(point_coords=np.array([[[20, 30], [40, 10]]], np.float32),
                   point_labels=np.array([[1, 0]], np.int32)),
    "multimask": dict(boxes=np.array([[2, 3, 30, 40]], np.float32), multimask_output=True),
}


@pytest.fixture(scope="module")
def predictors(tiny):
    """kind → (Flax params, port predictor); one JAX predictor, its jitted
    programs compiled once, takes either kind's parameters."""
    state = tiny[0]
    out = {}
    for kind, st in (("seeded", state), ("mixed", mixed_state(state))):
        params, model = _pair(st, ts.TINY_SAM)
        out[kind] = (params, ts.SamPredictor(model, device="cpu"))
    return js.SamPredictor(js.TINY_SAM, out["seeded"][0]), out


@pytest.mark.parametrize("frame", sorted(FRAMES))
@pytest.mark.parametrize("kind", ["seeded", "mixed"])
def test_predictor_matches_jax(predictors, frame, kind):
    jp, pairs = predictors
    jp.params, tp = pairs[kind]
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, FRAMES[frame] + (3,), dtype=np.uint8)
    img[10:40, 20:60] = 255
    jp.set_image(img)
    tp.set_image(img)
    assert tp._input_size == jp._input_size
    for name, kw in PREDICTS.items():
        want = jp.predict(return_logits=True, **kw)
        got = tp.predict(return_logits=True, **kw)
        for g, w, what in zip(got, want, ("logits", "iou", "low_res")):
            assert rel_err(g, w) <= TOL, (name, what)
        masks = tp.predict(**kw)[0]
        ref = jp.predict(**kw)[0]
        assert masks.dtype == bool and masks.shape == ref.shape == (
            ref.shape[0], ref.shape[1]) + FRAMES[frame]
        assert (masks == ref).mean() >= 0.999, name
        if kind == "mixed" and name == "boxes":
            assert 0.05 < ref.mean() < 0.95


def test_predict_needs_set_image(tiny):
    with pytest.raises(RuntimeError, match="set_image"):
        ts.SamPredictor(tiny[2], device="cpu").predict(boxes=np.zeros((1, 4), np.float32))


def test_pretrained_sam_loads_a_checkpoint(tmp_path, tiny):
    """An official-format checkpoint (here the synthetic state dict saved by
    ``torch.save``, once wrapped as ``{'state_dict': ...}`` with
    ``module.`` prefixes) loads by its own keys; the gt tooling's
    ``for_checkpoint`` builds the segmenter from it."""
    from nsof_tpu_torch.data.gt_tooling import TorchSamSegmenter

    state = {k: torch.from_numpy(v) for k, v in tiny[0].items()}
    plain, wrapped = tmp_path / "sam_plain.pth", tmp_path / "sam_wrapped.pth"
    torch.save(state, plain)
    torch.save({"state_dict": {f"module.{k}": v for k, v in state.items()}}, wrapped)
    for path in (plain, wrapped):
        model = ts.pretrained_sam(str(path), ts.TINY_SAM)
        for k, v in model.state_dict().items():
            assert torch.equal(v, state[k]), k
    with pytest.raises(ValueError, match="width 32"):
        ts.load_sam_state(str(plain))  # inferred: TINY_SAM is no official width
    seg = TorchSamSegmenter(tiny[2], device="cpu")
    masks = seg(np.zeros((60, 80, 3), np.uint8), "anything")  # the whole frame as the box
    assert len(masks) == 1 and masks[0].shape == (60, 80)
