"""Tiny seeded Hugging Face models in local directories, for the tests of
``nsof_tpu_torch/data/gt_tooling.py``'s Hugging Face classes on the CPU
(``tests/test_torch_owlvit.py``) and on the card
(``tests/test_torch_paths_cuda.py``).  Imports ``transformers`` inside each
function, and neither ``jax`` nor the JAX package."""

import json

import numpy as np
import torch

from nsof_tpu_torch.data import gt_tooling as tgt
from nsof_tpu_torch.models import owlvit as to


def owlvit_hf_config():
    """Hugging Face's ``OwlViTConfig`` at the port's ``TINY_OWLVIT``."""
    from transformers import OwlViTConfig

    cfg = to.TINY_OWLVIT
    return OwlViTConfig(
        projection_dim=cfg.projection_dim,
        text_config=dict(vocab_size=cfg.vocab_size, hidden_size=cfg.text_width,
                         intermediate_size=cfg.text_mlp, num_hidden_layers=cfg.text_layers,
                         num_attention_heads=cfg.text_heads,
                         max_position_embeddings=cfg.max_text_len),
        vision_config=dict(hidden_size=cfg.vision_width, intermediate_size=cfg.vision_mlp,
                           num_hidden_layers=cfg.vision_layers,
                           num_attention_heads=cfg.vision_heads, image_size=cfg.image_size,
                           patch_size=cfg.patch_size),
    )


def tiny_hf_dirs(root):
    """Local directories of a Hugging Face OWL-ViT at ``TINY_OWLVIT`` (with
    a CLIP tokenizer of single letters, "!" id 0 and EOS the highest id) and
    of a SAM with 64² input, both from ``torch.manual_seed(0)``:
    ``(owl_dir, sam_dir)``."""
    from transformers import (CLIPTokenizer, OwlViTForObjectDetection, OwlViTImageProcessor,
                              OwlViTProcessor, SamConfig, SamImageProcessor, SamModel,
                              SamProcessor)

    cfg = to.TINY_OWLVIT
    owl, sam = root / "owlvit", root / "sam"
    torch.manual_seed(0)
    OwlViTForObjectDetection(owlvit_hf_config()).save_pretrained(owl)
    vocab = {"!": 0}
    for ch in "abcdefghijklmnopqrstuvwxyz":
        vocab[ch], vocab[ch + "</w>"] = len(vocab), len(vocab) + 1
    vocab["<|startoftext|>"], vocab["<|endoftext|>"] = len(vocab), len(vocab) + 1
    (owl / "vocab.json").write_text(json.dumps(vocab))
    (owl / "merges.txt").write_text("#version: 0.2\n")
    tok = CLIPTokenizer(str(owl / "vocab.json"), str(owl / "merges.txt"),
                        model_max_length=cfg.max_text_len)
    OwlViTProcessor(OwlViTImageProcessor(size=cfg.image_size, crop_size=cfg.image_size),
                    tok).save_pretrained(owl)
    SamModel(SamConfig(
        vision_config=dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                           num_attention_heads=2, image_size=64, patch_size=16,
                           output_channels=32, window_size=2, global_attn_indexes=[1],
                           mlp_dim=64, num_pos_feats=16),
        prompt_encoder_config=dict(hidden_size=32, image_size=64, patch_size=16,
                                   mask_input_channels=4),
        mask_decoder_config=dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                                 mlp_dim=64, iou_head_hidden_dim=32),
    )).save_pretrained(sam)
    SamProcessor(SamImageProcessor(size={"longest_edge": 64},
                                   pad_size={"height": 64, "width": 64})).save_pretrained(sam)
    return owl, sam


def drive_hf_classes(owl_dir, sam_dir, **kw):
    """``OwlVitBoxProposer`` → ``TransformersSamSegmenter`` on a 48×64
    frame, built with ``kw``; returns (proposer, segmenter, masks) after
    checking both models lie on the segmenter's device and the boxes and
    masks fit the frame."""
    frame = np.random.default_rng(5).integers(0, 255, (48, 64, 3), dtype=np.uint8)
    owl = tgt.OwlVitBoxProposer(str(owl_dir), score_threshold=0.0, **kw)
    seg = tgt.TransformersSamSegmenter(str(sam_dir), box_proposer=owl, **kw)
    for model in (owl.model, seg.model):
        assert {p.device for p in model.parameters()} == {seg.device}
    boxes = np.asarray(owl(frame, "bright object"))
    assert boxes.shape == (16, 4) and np.isfinite(boxes).all()  # a box a patch at 0
    masks = seg(frame, "bright object")
    assert len(masks) == 16 and all(m.shape == (48, 64) and m.dtype == bool for m in masks)
    return owl, seg, masks
