"""OWL-ViT in PyTorch: the port of :mod:`nsof_tpu.models.owlvit`.

Open-vocabulary text → box grounding, the GroundingDINO stage of the
reference's LangSAM chain (codebase/lang-segment-anything/lang_sam/
lang_sam.py:91-103): a CLIP dual tower whose patch tokens become detection
queries through a class-similarity head and a box-regression head
(Minderer et al. 2022).

The modules carry Hugging Face ``OwlViTForObjectDetection``'s names, so its
state dict (``google/owlvit-base-patch32`` and the other published
checkpoints) loads by its own keys (:func:`load_owlvit_state`); only CLIP's
contrastive head (``owlvit.visual_projection``, ``owlvit.logit_scale``),
which detection does not use, is left out.  :func:`params_from_jax` maps the
JAX package's converted Flax tree to the same names.

The forward is the JAX module's, in NCHW pixels: the patch embedding as a
strided convolution, the class token and learned positions, pre- and
post-LayerNorm, quick-GELU MLPs; the text tower's causal mask plus a −1e9
padding bias, pooled at the EOS token (the argmax of the ids); the merged
LayerNorm of the patch tokens times the class token; the class head's
cosine similarity (1e-6 added to both norms, the query already normalised
without it), shift and ``elu(scale) + 1``; padding queries (first id 0)
masked to float32's minimum; the erf-GELU box MLP with the grid's log-odds
bias and a sigmoid.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "OwlVitConfig", "TINY_OWLVIT", "BASE_PATCH32", "OwlVit", "infer_owlvit_config",
    "load_owlvit_state", "params_from_jax", "synthetic_owlvit_state_dict",
    "post_process_detection", "CLIP_HEAD_KEYS",
]

#: CLIP's contrastive head in a Hugging Face checkpoint: not used by detection.
CLIP_HEAD_KEYS = ("owlvit.visual_projection.weight", "owlvit.logit_scale")


@dataclasses.dataclass(frozen=True)
class OwlVitConfig:
    # vision tower
    image_size: int = 768
    patch_size: int = 32
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    vision_mlp: int = 3072
    # text tower
    vocab_size: int = 49408
    text_width: int = 512
    text_layers: int = 12
    text_heads: int = 8
    text_mlp: int = 2048
    max_text_len: int = 16
    # joint
    projection_dim: int = 512
    layer_norm_eps: float = 1e-5

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size


#: ``google/owlvit-base-patch32``'s published widths (the defaults).
BASE_PATCH32 = OwlVitConfig()

#: The JAX package's tiny configuration for parity tests.
TINY_OWLVIT = OwlVitConfig(image_size=64, patch_size=16, vision_width=32, vision_layers=2,
                           vision_heads=2, vision_mlp=64, vocab_size=99, text_width=24,
                           text_layers=2, text_heads=2, text_mlp=48, max_text_len=16,
                           projection_dim=24)


def _quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class OwlAttention(nn.Module):
    """Multi-head attention with an optional additive bias."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.k_proj = nn.Linear(width, width)
        self.v_proj = nn.Linear(width, width)
        self.q_proj = nn.Linear(width, width)
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, bias=None) -> torch.Tensor:
        b, n, c = x.shape
        hd = c // self.heads

        def split(t):
            return t.reshape(b, n, self.heads, hd).transpose(1, 2)

        q = split(self.q_proj(x) * hd**-0.5)
        logits = torch.matmul(q, split(self.k_proj(x)).transpose(-2, -1))
        if bias is not None:
            logits = logits + bias
        out = torch.matmul(logits.softmax(dim=-1), split(self.v_proj(x)))
        return self.out_proj(out.transpose(1, 2).reshape(b, n, c))


class OwlMLP(nn.Module):
    def __init__(self, width: int, mlp: int):
        super().__init__()
        self.fc1 = nn.Linear(width, mlp)
        self.fc2 = nn.Linear(mlp, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(_quick_gelu(self.fc1(x)))


class EncoderLayer(nn.Module):
    """Pre-LN transformer block with a quick-GELU MLP."""

    def __init__(self, width: int, heads: int, mlp: int, eps: float):
        super().__init__()
        self.self_attn = OwlAttention(width, heads)
        self.layer_norm1 = nn.LayerNorm(width, eps=eps)
        self.mlp = OwlMLP(width, mlp)
        self.layer_norm2 = nn.LayerNorm(width, eps=eps)

    def forward(self, x: torch.Tensor, bias=None) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), bias)
        return x + self.mlp(self.layer_norm2(x))


class Encoder(nn.Module):
    def __init__(self, width: int, heads: int, mlp: int, depth: int, eps: float):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(width, heads, mlp, eps) for _ in range(depth))

    def forward(self, x: torch.Tensor, bias=None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, bias)
        return x


class VisionEmbeddings(nn.Module):
    def __init__(self, cfg: OwlVitConfig):
        super().__init__()
        d = cfg.vision_width
        self.class_embedding = nn.Parameter(torch.zeros(d))
        self.patch_embedding = nn.Conv2d(3, d, cfg.patch_size, cfg.patch_size, bias=False)
        self.position_embedding = nn.Embedding(cfg.grid * cfg.grid + 1, d)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        x = self.patch_embedding(pixel_values).flatten(2).transpose(1, 2)
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        return torch.cat([cls, x], dim=1) + self.position_embedding.weight[None]


class VisionTransformer(nn.Module):
    """CLIP ViT → the post-LayerNorm token sequence, class token first (the
    detection heads take all of it)."""

    def __init__(self, cfg: OwlVitConfig):
        super().__init__()
        eps = cfg.layer_norm_eps
        self.embeddings = VisionEmbeddings(cfg)
        self.pre_layernorm = nn.LayerNorm(cfg.vision_width, eps=eps)
        self.encoder = Encoder(cfg.vision_width, cfg.vision_heads, cfg.vision_mlp,
                               cfg.vision_layers, eps)
        self.post_layernorm = nn.LayerNorm(cfg.vision_width, eps=eps)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        x = self.pre_layernorm(self.embeddings(pixel_values))
        return self.post_layernorm(self.encoder(x))


class TextEmbeddings(nn.Module):
    def __init__(self, cfg: OwlVitConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.text_width)
        self.position_embedding = nn.Embedding(cfg.max_text_len, cfg.text_width)


class TextTransformer(nn.Module):
    """CLIP text transformer: causal pre-LN encoder with a −1e9 padding
    bias, final LayerNorm, pooled at the EOS token (the argmax of the ids:
    EOS is the highest id in CLIP's vocabulary)."""

    def __init__(self, cfg: OwlVitConfig):
        super().__init__()
        self.embeddings = TextEmbeddings(cfg)
        self.encoder = Encoder(cfg.text_width, cfg.text_heads, cfg.text_mlp, cfg.text_layers,
                               cfg.layer_norm_eps)
        self.final_layer_norm = nn.LayerNorm(cfg.text_width, eps=cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        n, seq = input_ids.shape
        emb = self.embeddings
        x = emb.token_embedding(input_ids) + emb.position_embedding.weight[None, :seq]
        causal = torch.triu(torch.full((seq, seq), -1e9, device=x.device), diagonal=1)
        pad = torch.where(input_ids > 0, 0.0, -1e9)
        x = self.final_layer_norm(self.encoder(x, causal[None, None] + pad[:, None, None, :]))
        return x[torch.arange(n, device=x.device), input_ids.argmax(dim=-1)]


class OwlViTModel(nn.Module):
    def __init__(self, cfg: OwlVitConfig):
        super().__init__()
        self.text_model = TextTransformer(cfg)
        self.vision_model = VisionTransformer(cfg)
        self.text_projection = nn.Linear(cfg.text_width, cfg.projection_dim, bias=False)


class ClassHead(nn.Module):
    def __init__(self, cfg: OwlVitConfig):
        super().__init__()
        self.dense0 = nn.Linear(cfg.vision_width, cfg.text_width)
        self.logit_shift = nn.Linear(cfg.vision_width, 1)
        self.logit_scale = nn.Linear(cfg.vision_width, 1)


class BoxHead(nn.Module):
    def __init__(self, cfg: OwlVitConfig):
        super().__init__()
        w = cfg.vision_width
        self.dense0 = nn.Linear(w, w)
        self.dense1 = nn.Linear(w, w)
        self.dense2 = nn.Linear(w, 4)


@functools.lru_cache(maxsize=8)
def _box_bias(gh: int, gw: int, device: str) -> torch.Tensor:
    """The grid prior: each patch's box biased (in logit space) to centre
    on its cell with a side of one cell (compute_box_bias,
    modeling_owlvit.py:1215-1235), in float32 numpy as the JAX module
    builds it."""
    xs = np.arange(1, gw + 1, dtype=np.float32) / gw
    ys = np.arange(1, gh + 1, dtype=np.float32) / gh
    xx, yy = np.meshgrid(xs, ys)
    coords = np.stack([xx, yy], axis=-1).reshape(-1, 2).clip(0.0, 1.0)
    coord_bias = np.log(coords + 1e-4) - np.log1p(-coords + 1e-4)
    size = np.full_like(coords, 1.0)
    size[:, 0] /= gw
    size[:, 1] /= gh
    size_bias = np.log(size + 1e-4) - np.log1p(-size + 1e-4)
    return torch.from_numpy(np.concatenate([coord_bias, size_bias], axis=-1)).to(device)


class OwlVit(nn.Module):
    """OWL-ViT open-vocabulary detector.

    ``pixel_values``: ``[B, 3, H, W]`` CLIP-normalised floats.
    ``input_ids``: ``[B, Q, L]`` tokenised queries, 0-padded; a query whose
    first id is 0 is padding (Hugging Face's ``query_mask``).

    Returns ``logits`` ``[B, P, Q]`` and ``pred_boxes`` ``[B, P, 4]``
    (normalised cxcywh), the outputs of ``OwlViTForObjectDetection``, with
    the merged patch features ``image_embeds`` and the unit-norm
    ``query_embeds``."""

    def __init__(self, cfg: OwlVitConfig):
        super().__init__()
        self.config = cfg
        self.owlvit = OwlViTModel(cfg)
        self.layer_norm = nn.LayerNorm(cfg.vision_width, eps=cfg.layer_norm_eps)
        self.class_head = ClassHead(cfg)
        self.box_head = BoxHead(cfg)

    def forward(self, pixel_values: torch.Tensor, input_ids: torch.Tensor) -> dict:
        b, q, seq = input_ids.shape
        tokens = self.owlvit.vision_model(pixel_values)
        query = self.owlvit.text_projection(self.owlvit.text_model(input_ids.reshape(b * q, seq)))
        query = (query / torch.linalg.norm(query, dim=-1, keepdim=True)).reshape(b, q, -1)

        feats = self.layer_norm(tokens[:, 1:] * tokens[:, :1])
        ch = self.class_head
        img = ch.dense0(feats)
        img = img / (torch.linalg.norm(img, dim=-1, keepdim=True) + 1e-6)
        query_n = query / (torch.linalg.norm(query, dim=-1, keepdim=True) + 1e-6)
        logits = torch.einsum("bpd,bqd->bpq", img, query_n)
        scale = F.elu(ch.logit_scale(feats)) + 1.0
        logits = (logits + ch.logit_shift(feats)) * scale
        valid = input_ids[:, :, 0] > 0
        logits = torch.where(valid[:, None, :], logits, torch.finfo(torch.float32).min)

        bh = self.box_head
        h = bh.dense2(F.gelu(bh.dense1(F.gelu(bh.dense0(feats)))))
        gh = pixel_values.shape[-2] // self.config.patch_size
        gw = pixel_values.shape[-1] // self.config.patch_size
        boxes = torch.sigmoid(h + _box_bias(gh, gw, str(h.device))[None])
        return {"logits": logits, "pred_boxes": boxes, "image_embeds": feats,
                "query_embeds": query}


# ---------------------------------------------------------------------------
# weights: Hugging Face state dicts, the JAX package's tree
# ---------------------------------------------------------------------------


def infer_owlvit_config(state: Mapping[str, Any]) -> OwlVitConfig:
    """Tower widths and depths from a Hugging Face state dict; the heads
    follow the published configurations (width / 64)."""
    shape = lambda k: tuple(state[k].shape)  # noqa: E731
    vw = shape("owlvit.vision_model.embeddings.class_embedding")[0]
    patch = shape("owlvit.vision_model.embeddings.patch_embedding.weight")[-1]
    npos = shape("owlvit.vision_model.embeddings.position_embedding.weight")[0]
    vocab, tw = shape("owlvit.text_model.embeddings.token_embedding.weight")

    def depth(tower):
        return len({k.split(".")[4] for k in state
                    if k.startswith(f"owlvit.{tower}.encoder.layers.")})

    return OwlVitConfig(
        image_size=math.isqrt(npos - 1) * patch, patch_size=patch, vision_width=vw,
        vision_layers=depth("vision_model"), vision_heads=max(1, vw // 64),
        vision_mlp=shape("owlvit.vision_model.encoder.layers.0.mlp.fc1.weight")[0],
        vocab_size=vocab, text_width=tw, text_layers=depth("text_model"),
        text_heads=max(1, tw // 64),
        text_mlp=shape("owlvit.text_model.encoder.layers.0.mlp.fc1.weight")[0],
        max_text_len=shape("owlvit.text_model.embeddings.position_embedding.weight")[0],
        projection_dim=shape("owlvit.text_projection.weight")[0],
    )


def load_owlvit_state(state: Mapping[str, Any], cfg: OwlVitConfig | None = None) -> OwlVit:
    """:class:`OwlVit` holding a Hugging Face ``OwlViTForObjectDetection``
    state dict, by its own keys (strict but for :data:`CLIP_HEAD_KEYS`), on
    the CPU."""
    model = OwlVit(cfg or infer_owlvit_config(state))
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()
                           if k not in CLIP_HEAD_KEYS})
    return model


def params_from_jax(params: Mapping[str, Any], cfg: OwlVitConfig) -> dict[str, torch.Tensor]:
    """The JAX package's Flax tree of ``convert_owlvit`` (as numpy arrays)
    → a state dict of the port's :class:`OwlVit`.  Raises ``ValueError`` on
    a missing or unused tensor or a shape that differs."""
    params = params.get("params", params)
    flat: dict[str, np.ndarray] = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, prefix + (k,))
            else:
                flat["/".join(prefix + (k,))] = np.array(v, dtype=np.float32)

    walk(params, ())
    used, state = set(), {}

    def take(path):
        used.add(path)
        return flat[path]

    def dense(key, path, bias=True):
        state[f"{key}.weight"] = take(f"{path}/kernel").T
        if bias:
            state[f"{key}.bias"] = take(f"{path}/bias")

    def ln(key, path):
        state[f"{key}.weight"] = take(f"{path}/scale")
        state[f"{key}.bias"] = take(f"{path}/bias")

    def block(key, path):
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            dense(f"{key}.self_attn.{name}", f"{path}/self_attn/{name}")
        ln(f"{key}.layer_norm1", f"{path}/layer_norm1")
        ln(f"{key}.layer_norm2", f"{path}/layer_norm2")
        dense(f"{key}.mlp.fc1", f"{path}/fc1")
        dense(f"{key}.mlp.fc2", f"{path}/fc2")

    errors = []
    try:
        vp, p = "owlvit.vision_model.", cfg.patch_size
        kernel = take("vision/patch_embed/kernel")  # [(ph, pw, c), D]
        state[vp + "embeddings.patch_embedding.weight"] = (
            kernel.reshape(p, p, 3, -1).transpose(3, 2, 0, 1))
        state[vp + "embeddings.class_embedding"] = take("vision/class_embedding")
        state[vp + "embeddings.position_embedding.weight"] = take("vision/position_embedding")
        ln(vp + "pre_layernorm", "vision/pre_layernorm")
        ln(vp + "post_layernorm", "vision/post_layernorm")
        for i in range(cfg.vision_layers):
            block(f"{vp}encoder.layers.{i}", f"vision/layers_{i}")
        tp = "owlvit.text_model."
        state[tp + "embeddings.token_embedding.weight"] = take("text/token_embedding")
        state[tp + "embeddings.position_embedding.weight"] = take("text/position_embedding")
        ln(tp + "final_layer_norm", "text/final_layer_norm")
        for i in range(cfg.text_layers):
            block(f"{tp}encoder.layers.{i}", f"text/layers_{i}")
        dense("owlvit.text_projection", "text_projection", bias=False)
        ln("layer_norm", "merged_layer_norm")
        dense("class_head.dense0", "class_dense0")
        dense("class_head.logit_shift", "logit_shift")
        dense("class_head.logit_scale", "logit_scale")
        for name in ("dense0", "dense1", "dense2"):
            dense(f"box_head.{name}", f"box_{name}")
    except KeyError as e:
        errors.append(f"no Flax source {e}")
    errors += [f"{k}: unused Flax parameter" for k in flat if k not in used]
    target = OwlVit(cfg).state_dict()
    errors += [f"{k}: no Flax source" for k in target if k not in state]
    errors += [f"{k}: shape {state[k].shape} != {tuple(v.shape)}"
               for k, v in target.items() if k in state and state[k].shape != tuple(v.shape)]
    if errors:
        raise ValueError("OWL-ViT parameter conversion:\n" + "\n".join(errors))
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in state.items()}


def synthetic_owlvit_state_dict(cfg: OwlVitConfig, seed: int = 0) -> dict[str, np.ndarray]:
    """Random weights with a Hugging Face ``OwlViTForObjectDetection``'s
    keys and shapes for ``cfg`` (less CLIP's contrastive head), drawn from
    ``numpy.random.default_rng(seed)`` in :class:`OwlVit`'s parameter order:
    N(0, 0.05) float32, LayerNorm scales 1 + N(0, 0.05).  No published
    weights are in the repository; the JAX converter takes the same dict."""
    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in OwlVit(cfg).state_dict().items()}
    out = {}
    for key, shape in shapes.items():
        w = rng.normal(0, 0.05, shape).astype(np.float32)
        if "norm" in key and key.endswith(".weight"):
            w += np.float32(1)
        out[key] = w
    return out


def post_process_detection(logits: np.ndarray, pred_boxes: np.ndarray,
                           target_hw: tuple[int, int], threshold: float = 0.3):
    """Hugging Face ``post_process_object_detection`` for one image: each
    patch's best query, its sigmoid score thresholded, cxcywh → xyxy in
    pixels.  Returns (boxes ``(N, 4)``, scores ``(N,)``, labels ``(N,)``)."""
    logits = np.asarray(logits)
    pred_boxes = np.asarray(pred_boxes)
    labels = logits.argmax(axis=-1)
    scores = 1.0 / (1.0 + np.exp(-logits.max(axis=-1)))
    keep = scores > threshold
    cxcywh = pred_boxes[keep]
    h, w = target_hw
    x0 = (cxcywh[:, 0] - cxcywh[:, 2] / 2) * w
    y0 = (cxcywh[:, 1] - cxcywh[:, 3] / 2) * h
    x1 = (cxcywh[:, 0] + cxcywh[:, 2] / 2) * w
    y1 = (cxcywh[:, 1] + cxcywh[:, 3] / 2) * h
    return np.stack([x0, y0, x1, y1], axis=-1), scores[keep], labels[keep]
