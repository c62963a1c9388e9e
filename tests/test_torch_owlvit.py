"""The port's OWL-ViT (``nsof_tpu_torch/models/owlvit.py``) against the JAX
package's Flax OWL-ViT and Hugging Face's ``OwlViTForObjectDetection``, on
the CPU, at ``TINY_OWLVIT``.

Hugging Face's model is built at that configuration from
``torch.manual_seed(0)`` (no download); its state dict feeds the JAX
converter ``convert_owlvit`` (the Flax parameters, without ``OwlVit.init``)
and the port's ``load_owlvit_state`` by its own keys.

- The forward with two queries, one of them padding (first id 0): the valid
  query's logits and every box within 1e-4 of the largest magnitude of
  Flax's and of Hugging Face's (measured ≤ 4e-7 and 0); the padding query
  masked to float32's minimum in all three; the merged patch features and
  query embeddings against Flax's.
- ``params_from_jax`` of the Flax tree equals the Hugging Face state dict
  (less CLIP's contrastive head) bit for bit; a missing tensor raises.
- ``infer_owlvit_config`` on the Hugging Face state dict (the JAX test's
  fields), and ``load_owlvit_state``'s strictness.
- ``post_process_detection`` equal to the JAX function and, within 1e-3 px,
  to Hugging Face's ``post_process_object_detection``.
- ``data/gt_tooling.py``'s Hugging Face classes ``OwlVitBoxProposer`` and
  ``TransformersSamSegmenter``, read from local directories that hold tiny
  seeded models (``tests/tiny_hf.py``), on the device they are given: the
  model and its inputs on it, the boxes and masks in the frame's size.
"""

import jax
import numpy as np
import pytest
import torch

from nsof_tpu.models import owlvit as jo
from nsof_tpu_torch.models import owlvit as to
from tiny_hf import drive_hf_classes, owlvit_hf_config, tiny_hf_dirs
from torch_single_thread import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-4  # of the largest magnitude


@pytest.fixture(scope="module")
def tiny():
    from transformers import OwlViTForObjectDetection

    cfg = to.TINY_OWLVIT
    torch.manual_seed(0)
    hf = OwlViTForObjectDetection(owlvit_hf_config()).eval()
    state = hf.state_dict()
    _, params = jo.convert_owlvit(state, jo.TINY_OWLVIT)
    return hf, state, params, to.load_owlvit_state(state, cfg).eval()


def _inputs():
    rng = np.random.default_rng(7)
    pixels = rng.standard_normal((1, 3, 64, 64), dtype=np.float32)
    ids = np.zeros((2, 16), np.int64)
    ids[0, :5] = [1, 42, 17, 9, 98]  # 98: the EOS, the highest id present
    return pixels, ids


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_forward_matches_jax_and_hf(tiny):
    hf, _, params, model = tiny
    pixels, ids = _inputs()
    flax = jax.jit(jo.OwlVit(jo.TINY_OWLVIT).apply)(
        {"params": params}, pixels.transpose(0, 2, 3, 1), ids.reshape(1, 2, -1))
    with torch.no_grad():
        got = model(torch.from_numpy(pixels), torch.from_numpy(ids.reshape(1, 2, -1)))
        ref = hf(input_ids=torch.from_numpy(ids), pixel_values=torch.from_numpy(pixels),
                 attention_mask=torch.from_numpy((ids > 0).astype(np.int64)))
    logits = got["logits"].numpy()
    for want_logits, want_boxes in ((flax["logits"], flax["pred_boxes"]),
                                    (ref.logits.numpy(), ref.pred_boxes.numpy())):
        want_logits = np.asarray(want_logits)
        assert rel_err(logits[..., 0], want_logits[..., 0]) <= TOL
        assert rel_err(got["pred_boxes"].numpy(), want_boxes) <= TOL
        assert (want_logits[..., 1] == np.finfo(np.float32).min).all()
    assert (logits[..., 1] == np.finfo(np.float32).min).all()
    for k in ("image_embeds", "query_embeds"):
        assert rel_err(got[k].numpy(), flax[k]) <= TOL, k


def test_params_from_jax_round_trip(tiny):
    _, state, params, _ = tiny
    tree = jax.tree.map(np.asarray, params)
    got = to.params_from_jax(tree, to.TINY_OWLVIT)
    assert set(got) == set(state) - set(to.CLIP_HEAD_KEYS)
    for k, v in got.items():
        torch.testing.assert_close(v, state[k], rtol=0, atol=0, msg=k)
    del tree["box_dense2"]
    with pytest.raises(ValueError, match="box_dense2"):
        to.params_from_jax(tree, to.TINY_OWLVIT)


def test_config_and_strict_load(tiny):
    _, state, _, _ = tiny
    cfg = to.infer_owlvit_config(state)
    for field in ("image_size", "patch_size", "vision_width", "vision_layers", "vision_mlp",
                  "text_width", "text_layers", "text_mlp", "vocab_size", "max_text_len",
                  "projection_dim"):
        assert getattr(cfg, field) == getattr(to.TINY_OWLVIT, field), field
    assert cfg == to.OwlVitConfig(**{**to.TINY_OWLVIT.__dict__, "vision_heads": 1,
                                     "text_heads": 1})  # width // 64, as the JAX converter
    assert to.BASE_PATCH32 == to.OwlVitConfig() and to.BASE_PATCH32.grid == 24
    extra = dict(state)
    extra["box_head.dense3.weight"] = torch.zeros(4, 32)
    with pytest.raises(RuntimeError, match="dense3"):
        to.load_owlvit_state(extra, to.TINY_OWLVIT)


def test_post_process_matches_jax_and_hf():
    from transformers import OwlViTImageProcessor

    rng = np.random.default_rng(3)
    logits = rng.standard_normal((1, 16, 2)).astype(np.float32) * 3
    boxes = rng.uniform(0.1, 0.6, size=(1, 16, 4)).astype(np.float32)

    class _Out:
        pass

    out = _Out()
    out.logits, out.pred_boxes = torch.from_numpy(logits), torch.from_numpy(boxes)
    ref = OwlViTImageProcessor().post_process_object_detection(
        out, threshold=0.5, target_sizes=torch.tensor([[480, 640]]))[0]
    got = to.post_process_detection(logits[0], boxes[0], (480, 640), threshold=0.5)
    want = jo.post_process_detection(logits[0], boxes[0], (480, 640), threshold=0.5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    order = np.argsort(ref["scores"].numpy())[::-1]
    mine = np.argsort(got[1])[::-1]
    assert len(got[1]) == len(order) > 0
    np.testing.assert_allclose(got[0][mine], ref["boxes"].numpy()[order], rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got[2][mine], ref["labels"].numpy()[order])



def test_hf_classes_run_on_their_device(tmp_path):
    owl, seg, _ = drive_hf_classes(*tiny_hf_dirs(tmp_path), device="cpu")
    assert owl.device == seg.device == torch.device("cpu")
