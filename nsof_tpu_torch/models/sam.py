"""Segment Anything (SAM) in PyTorch: the port of :mod:`nsof_tpu.models.sam`.

The promptable segmenter behind the ground-truth mask tooling (the
reference's LangSAM chain, codebase/lang-segment-anything/lang_sam/
lang_sam.py:105-115, box prompts, ``multimask_output=False``): the ViTDet
image encoder (windowed attention with decomposed relative positions), the
prompt encoder (random-Fourier positional encoding, point, box and mask
prompts) and the two-way-transformer mask decoder with hypernetwork mask
heads, at every width of the official registry (build_sam.py:14-44: vit_b,
vit_l, vit_h).

The modules carry segment-anything's names, so an official
``sam_vit_{b,l,h}.pth`` state dict loads into :class:`Sam` with
``load_state_dict(strict=True)`` (:func:`load_sam_state`,
:func:`pretrained_sam`); :func:`params_from_jax` maps the JAX package's
converted Flax tree back to those names.  The layouts are torch's: NCHW
images, embeddings and mask inputs, NHWC tokens inside the encoder, as
segment-anything keeps them.

Resizes are the JAX package's, not ``F.interpolate``'s
(:mod:`nsof_tpu_torch.ops.resize`): ``postprocess`` resizes linearly with
antialiasing (a 480×640 frame is a 768×1024 → 480×640 shrink), a
relative-position table stored at another length is resized linearly, and
the position embedding at another input size with Keys' cubic (a = −0.5).
The JAX encoder refuses an input size other than ``img_size`` (its global
blocks' relative-position parameters take the input's shape), so the port's
resized encoder is held against the JAX resize functions piece by piece.

Numerical cares, as in the JAX module: exact-erf GELU; LayerNorm eps 1e-6 in
the encoder, the neck, the mask downscaling and the upscaling, torch's
default 1e-5 in the decoder transformer.  Everything runs on the model's
device; the predictor's entry points run on the card unless the caller
passes a CPU device.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nsof_tpu_torch import _build
from nsof_tpu_torch.data.imgproc import resize_linear
from nsof_tpu_torch.ops.resize import resize, resize_axis

__all__ = [
    "PIXEL_MEAN", "PIXEL_STD", "MASK_THRESHOLD", "SamConfig", "SAM_CONFIGS", "TINY_SAM",
    "Sam", "ImageEncoderViT", "PromptEncoder", "MaskDecoder", "rel_pos_table",
    "infer_sam_config", "load_sam_state", "pretrained_sam", "params_from_jax",
    "synthetic_sam_state_dict", "preprocess_shape", "SamPredictor",
]

PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)
MASK_THRESHOLD = 0.0
ENCODER_EPS = 1e-6  # build_sam.py:72; also LayerNorm2d's
DECODER_EPS = 1e-5  # nn.LayerNorm's default, the two-way transformer's


@dataclasses.dataclass(frozen=True)
class SamConfig:
    """Architecture hyperparameters (build_sam.py:55-101)."""

    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    global_attn_indexes: tuple[int, ...] = (2, 5, 8, 11)
    img_size: int = 1024
    patch_size: int = 16
    window_size: int = 14
    prompt_dim: int = 256
    mask_in_chans: int = 16
    num_multimask_outputs: int = 3
    decoder_depth: int = 2
    decoder_heads: int = 8
    decoder_mlp_dim: int = 2048

    @property
    def embedding_size(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_mask_tokens(self) -> int:
        return self.num_multimask_outputs + 1


#: Official checkpoint variants (build_sam.py:14-44).
SAM_CONFIGS: dict[str, SamConfig] = {
    "vit_b": SamConfig(768, 12, 12, (2, 5, 8, 11)),
    "vit_l": SamConfig(1024, 24, 16, (5, 11, 17, 23)),
    "vit_h": SamConfig(1280, 32, 16, (7, 15, 23, 31)),
}

#: The JAX package's small-but-faithful test architecture.
TINY_SAM = SamConfig(embed_dim=32, depth=3, num_heads=4, global_attn_indexes=(1,),
                     img_size=128, patch_size=16, window_size=4, prompt_dim=64,
                     mask_in_chans=8, decoder_mlp_dim=128)


class LayerNorm2d(nn.Module):
    """segment-anything's channel LayerNorm of an NCHW map (common.py:31-43)."""

    def __init__(self, channels: int, eps: float = ENCODER_EPS):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.permute(0, 2, 3, 1), (x.shape[1],), self.weight, self.bias, self.eps)
        return y.permute(0, 3, 1, 2)


class MLPBlock(nn.Module):
    """``lin1`` → activation → ``lin2`` (common.py:13-28)."""

    def __init__(self, dim: int, mlp_dim: int, act=nn.GELU):
        super().__init__()
        self.lin1 = nn.Linear(dim, mlp_dim)
        self.lin2 = nn.Linear(mlp_dim, dim)
        self.act = act()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lin2(self.act(self.lin1(x)))


# ---------------------------------------------------------------------------
# image encoder (ViTDet backbone, image_encoder.py)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=32)
def _rel_index(q_size: int, k_size: int, device: str) -> torch.Tensor:
    q_coords = np.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = np.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    idx = q_coords - k_coords + (k_size - 1) * max(q_size / k_size, 1.0)
    return torch.from_numpy(idx.astype(np.int64)).to(device)


def rel_pos_table(rel_pos: torch.Tensor, q_size: int, k_size: int) -> torch.Tensor:
    """The ``[q, k, head_dim]`` relative-position table (get_rel_pos,
    image_encoder.py:292-322); a table stored at another length is resized
    linearly with JAX's weights, as the JAX module resizes it."""
    max_rel = 2 * max(q_size, k_size) - 1
    rel_pos = resize_axis(rel_pos, 0, max_rel, "linear")
    return rel_pos[_rel_index(q_size, k_size, str(rel_pos.device))]


class Attention(nn.Module):
    """Multi-head attention with the decomposed relative-position bias
    (image_encoder.py:185-240, 325-361)."""

    def __init__(self, dim: int, num_heads: int, input_size: tuple[int, int]):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        hd = dim // num_heads
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, hd))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        nh = self.num_heads
        qkv = self.qkv(x).reshape(b, h * w, 3, nh, c // nh).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.unbind(0)  # each [B, heads, N, hd]
        attn = torch.matmul(q * self.scale, k.transpose(-2, -1))
        r_q = q.reshape(b, nh, h, w, c // nh)
        rel_h = torch.einsum("bnhwc,hkc->bnhwk", r_q, rel_pos_table(self.rel_pos_h, h, h))
        rel_w = torch.einsum("bnhwc,wkc->bnhwk", r_q, rel_pos_table(self.rel_pos_w, w, w))
        attn = attn.view(b, nh, h, w, h, w)
        attn.add_(rel_h[..., :, None]).add_(rel_w[..., None, :])
        attn = attn.view(b, nh, h * w, h * w).softmax(dim=-1)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, h, w, c)
        return self.proj(out)


class Block(nn.Module):
    """Pre-LN transformer block; a windowed block pads the normalised
    tokens with zeros to a multiple of the window, folds the windows into
    the batch and crops back (image_encoder.py:119-182, 243-289)."""

    def __init__(self, dim: int, num_heads: int, window_size: int, input_size: tuple[int, int]):
        super().__init__()
        self.window_size = window_size
        self.norm1 = nn.LayerNorm(dim, eps=ENCODER_EPS)
        self.attn = Attention(dim, num_heads,
                              input_size if window_size == 0 else (window_size, window_size))
        self.norm2 = nn.LayerNorm(dim, eps=ENCODER_EPS)
        self.mlp = MLPBlock(dim, 4 * dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        x = self.norm1(x)
        ws = self.window_size
        if ws > 0:
            b, h, w, c = x.shape
            ph, pw = (-h) % ws, (-w) % ws
            xp = F.pad(x, (0, 0, 0, pw, 0, ph))
            hp, wp = h + ph, w + pw
            xw = xp.view(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
            aw = self.attn(xw.reshape(-1, ws, ws, c))
            aw = aw.view(b, hp // ws, wp // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
            x = aw.reshape(b, hp, wp, c)[:, :h, :w]
        else:
            x = self.attn(x)
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, kernel_size=patch, stride=patch)


class ImageEncoderViT(nn.Module):
    """``[B, 3, H, W]`` normalised image → ``[B, prompt_dim, H/patch, W/patch]``
    embedding (image_encoder.py:17-116)."""

    def __init__(self, config: SamConfig):
        super().__init__()
        cfg = config
        s = cfg.embedding_size
        self.patch_embed = PatchEmbed(cfg.patch_size, cfg.embed_dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, s, s, cfg.embed_dim))
        self.blocks = nn.ModuleList(
            Block(cfg.embed_dim, cfg.num_heads,
                  0 if i in cfg.global_attn_indexes else cfg.window_size, (s, s))
            for i in range(cfg.depth))
        self.neck = nn.Sequential(
            nn.Conv2d(cfg.embed_dim, cfg.prompt_dim, 1, bias=False),
            LayerNorm2d(cfg.prompt_dim),
            nn.Conv2d(cfg.prompt_dim, cfg.prompt_dim, 3, padding=1, bias=False),
            LayerNorm2d(cfg.prompt_dim),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed.proj(x).permute(0, 2, 3, 1)
        pos = self.pos_embed
        for dim in (1, 2):  # another input size: JAX's bicubic resize
            pos = resize_axis(pos, dim, x.shape[dim], "cubic")
        x = x + pos
        for blk in self.blocks:
            x = blk(x)
        return self.neck(x.permute(0, 3, 1, 2))


# ---------------------------------------------------------------------------
# prompt encoder (prompt_encoder.py)
# ---------------------------------------------------------------------------


class PositionEmbeddingRandom(nn.Module):
    """Random-Fourier PE of [0, 1]-normalised coordinates
    (prompt_encoder.py:171-214)."""

    def __init__(self, num_pos_feats: int):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.zeros(2, num_pos_feats))

    def encode(self, coords01: torch.Tensor) -> torch.Tensor:
        c = torch.matmul(2.0 * coords01 - 1.0, self.positional_encoding_gaussian_matrix)
        c = (2.0 * np.pi) * c
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


class PromptEncoder(nn.Module):
    """Sparse (points, boxes) and dense (mask or no-mask) prompt embeddings
    (prompt_encoder.py:16-168).  Point labels: 1 positive, 0 negative, -1
    padding (PE zeroed, ``not_a_point_embed`` added)."""

    def __init__(self, config: SamConfig):
        super().__init__()
        self.config = config
        d, mc = config.prompt_dim, config.mask_in_chans
        self.pe_layer = PositionEmbeddingRandom(d // 2)
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, d) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, d)
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, mc // 4, kernel_size=2, stride=2), LayerNorm2d(mc // 4), nn.GELU(),
            nn.Conv2d(mc // 4, mc, kernel_size=2, stride=2), LayerNorm2d(mc), nn.GELU(),
            nn.Conv2d(mc, d, kernel_size=1),
        )
        self.no_mask_embed = nn.Embedding(1, d)

    def get_dense_pe(self) -> torch.Tensor:
        """``[1, D, S, S]`` PE of the embedding grid at pixel centres."""
        s = self.config.embedding_size
        dev = self.no_mask_embed.weight.device
        ys = (torch.arange(s, dtype=torch.float32, device=dev) + 0.5) / s
        xs = (torch.arange(s, dtype=torch.float32, device=dev) + 0.5) / s
        grid = torch.stack([xs[None, :].expand(s, s), ys[:, None].expand(s, s)], dim=-1)
        return self.pe_layer.encode(grid).permute(2, 0, 1)[None]

    def _embed_points(self, coords: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        pe = self.pe_layer.encode((coords + 0.5) / float(self.config.img_size))
        lab = labels[..., None]
        pe = torch.where(lab == -1, 0.0, pe)
        pe = pe + torch.where(lab == -1, self.not_a_point_embed.weight[0], 0.0)
        pe = pe + torch.where(lab == 0, self.point_embeddings[0].weight[0], 0.0)
        return pe + torch.where(lab == 1, self.point_embeddings[1].weight[0], 0.0)

    def _embed_boxes(self, boxes: torch.Tensor) -> torch.Tensor:
        corners = boxes.reshape(-1, 2, 2) + 0.5
        pe = self.pe_layer.encode(corners / float(self.config.img_size))
        corner = torch.cat([self.point_embeddings[2].weight, self.point_embeddings[3].weight])
        return pe + corner[None]

    def forward(self, point_coords: Optional[torch.Tensor], point_labels: Optional[torch.Tensor],
                boxes: Optional[torch.Tensor], mask_input: Optional[torch.Tensor]):
        """(sparse ``[B, N, D]``, dense ``[B, D, S, S]``).  Points in the
        input frame's pixels (``[B, P, 2]`` with ``[B, P]`` labels), boxes
        ``[B, 4]`` xyxy, a mask ``[B, 1, 4S, 4S]``.  Points without boxes
        get a padding point appended (label -1)."""
        d = self.config.prompt_dim
        parts, bs = [], 1
        if point_coords is not None:
            if boxes is None:
                n = point_coords.shape[0]
                point_coords = torch.cat([point_coords, point_coords.new_zeros(n, 1, 2)], 1)
                point_labels = torch.cat([point_labels, -point_labels.new_ones(n, 1)], 1)
            parts.append(self._embed_points(point_coords, point_labels))
            bs = point_coords.shape[0]
        if boxes is not None:
            parts.append(self._embed_boxes(boxes))
            bs = boxes.shape[0]
        dev = self.no_mask_embed.weight.device
        sparse = torch.cat(parts, dim=1) if parts else torch.zeros(bs, 0, d, device=dev)
        if mask_input is not None:
            dense = self.mask_downscaling(mask_input)
        else:
            s = self.config.embedding_size
            dense = self.no_mask_embed.weight.reshape(1, d, 1, 1).expand(bs, d, s, s)
        return sparse, dense


# ---------------------------------------------------------------------------
# mask decoder (transformer.py + mask_decoder.py)
# ---------------------------------------------------------------------------


class DownAttention(nn.Module):
    """Attention with internal-dim downsampling (transformer.py:185-240)."""

    def __init__(self, dim: int, num_heads: int, downsample: int = 1):
        super().__init__()
        inner = dim // downsample
        self.num_heads = num_heads
        self.q_proj = nn.Linear(dim, inner)
        self.k_proj = nn.Linear(dim, inner)
        self.v_proj = nn.Linear(dim, inner)
        self.out_proj = nn.Linear(inner, dim)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        return x.reshape(b, n, self.num_heads, c // self.num_heads).transpose(1, 2)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        q = self._heads(self.q_proj(q))
        k = self._heads(self.k_proj(k))
        v = self._heads(self.v_proj(v))
        attn = torch.matmul(q, k.transpose(-2, -1)) / math.sqrt(q.shape[-1])
        out = torch.matmul(attn.softmax(dim=-1), v)
        b, _, n, _ = out.shape
        return self.out_proj(out.transpose(1, 2).reshape(b, n, -1))


class TwoWayAttentionBlock(nn.Module):
    """Self-attention on the tokens, cross token → image, MLP, cross image
    → token (transformer.py:109-182)."""

    def __init__(self, dim: int, num_heads: int, mlp_dim: int, skip_first_layer_pe: bool):
        super().__init__()
        self.self_attn = DownAttention(dim, num_heads)
        self.norm1 = nn.LayerNorm(dim, eps=DECODER_EPS)
        self.cross_attn_token_to_image = DownAttention(dim, num_heads, 2)
        self.norm2 = nn.LayerNorm(dim, eps=DECODER_EPS)
        self.mlp = MLPBlock(dim, mlp_dim, nn.ReLU)
        self.norm3 = nn.LayerNorm(dim, eps=DECODER_EPS)
        self.norm4 = nn.LayerNorm(dim, eps=DECODER_EPS)
        self.cross_attn_image_to_token = DownAttention(dim, num_heads, 2)
        self.skip_first_layer_pe = skip_first_layer_pe

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    """(transformer.py:16-106)."""

    def __init__(self, depth: int, dim: int, num_heads: int, mlp_dim: int):
        super().__init__()
        self.layers = nn.ModuleList(TwoWayAttentionBlock(dim, num_heads, mlp_dim, i == 0)
                                    for i in range(depth))
        self.final_attn_token_to_image = DownAttention(dim, num_heads, 2)
        self.norm_final_attn = nn.LayerNorm(dim, eps=DECODER_EPS)

    def forward(self, image: torch.Tensor, image_pe: torch.Tensor, tokens: torch.Tensor):
        keys = image.flatten(2).transpose(1, 2)
        key_pe = image_pe.flatten(2).transpose(1, 2)
        queries = tokens
        for layer in self.layers:
            queries, keys = layer(queries, keys, tokens, key_pe)
        q, k = queries + tokens, keys + key_pe
        queries = self.norm_final_attn(queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys


class MLP(nn.Module):
    """ReLU MLP head (mask_decoder.py:154-176)."""

    def __init__(self, in_dim: int, hidden: int, out_dim: int, num_layers: int):
        super().__init__()
        dims = [in_dim] + [hidden] * (num_layers - 1)
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims, dims[1:] + [out_dim]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MaskDecoder(nn.Module):
    """Image and prompt embeddings → (low-res mask logits ``[B, nm, 4S,
    4S]``, IoU scores ``[B, nm]``) for every mask token
    (mask_decoder.py:16-149)."""

    def __init__(self, config: SamConfig):
        super().__init__()
        d, nm = config.prompt_dim, config.num_mask_tokens
        self.config = config
        self.transformer = TwoWayTransformer(config.decoder_depth, d, config.decoder_heads,
                                             config.decoder_mlp_dim)
        self.iou_token = nn.Embedding(1, d)
        self.mask_tokens = nn.Embedding(nm, d)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(d, d // 4, kernel_size=2, stride=2), LayerNorm2d(d // 4),
            nn.GELU(), nn.ConvTranspose2d(d // 4, d // 8, kernel_size=2, stride=2), nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(MLP(d, d, d // 8, 3) for _ in range(nm))
        self.iou_prediction_head = MLP(d, 256, nm, 3)

    def forward(self, image_embeddings: torch.Tensor, image_pe: torch.Tensor,
                sparse: torch.Tensor, dense: torch.Tensor):
        """``image_embeddings`` ``[1 or B, D, S, S]`` (broadcast over the
        prompts), ``image_pe`` ``[1, D, S, S]``, ``sparse`` ``[B, N, D]``,
        ``dense`` ``[B, D, S, S]``."""
        b, d = sparse.shape[0], self.config.prompt_dim
        nm = self.config.num_mask_tokens
        out_tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight])
        tokens = torch.cat([out_tokens[None].expand(b, -1, -1), sparse], dim=1)
        src = image_embeddings.expand(dense.shape) + dense
        hs, src = self.transformer(src, image_pe, tokens)
        x = self.output_upscaling(src.transpose(1, 2).reshape(dense.shape))
        hyper = torch.stack([mlp(hs[:, 1 + i]) for i, mlp in
                             enumerate(self.output_hypernetworks_mlps)], dim=1)
        h, w = x.shape[-2:]
        masks = torch.matmul(hyper, x.flatten(2)).view(b, nm, h, w)
        return masks, self.iou_prediction_head(hs[:, 0])


class Sam(nn.Module):
    """The three SAM modules under segment-anything's names (sam.py:18-50)."""

    def __init__(self, config: SamConfig):
        super().__init__()
        self.config = config
        self.image_encoder = ImageEncoderViT(config)
        self.prompt_encoder = PromptEncoder(config)
        self.mask_decoder = MaskDecoder(config)


# ---------------------------------------------------------------------------
# weights: official checkpoints, synthetic state dicts, the JAX package's tree
# ---------------------------------------------------------------------------


def infer_sam_config(state: Mapping[str, Any]) -> SamConfig:
    """vit_b, vit_l or vit_h from the encoder's embedding width
    (build_sam.py:14-44)."""
    dim = int(state["image_encoder.patch_embed.proj.weight"].shape[0])
    for cfg in SAM_CONFIGS.values():
        if cfg.embed_dim == dim:
            return cfg
    raise ValueError(f"unknown SAM encoder width {dim}")


def load_sam_state(path: str, config: Optional[SamConfig] = None
                   ) -> tuple[SamConfig, dict[str, torch.Tensor]]:
    """(config, state dict) of an official ``sam_vit_*.pth``; the config
    inferred unless given (as ``convert_sam``'s)."""
    from nsof_tpu_torch.models.convert import load_torch_state_dict

    state = load_torch_state_dict(path)
    return config or infer_sam_config(state), state


def pretrained_sam(path: str, config: Optional[SamConfig] = None) -> Sam:
    """:class:`Sam` with an official checkpoint's weights (all of them, by
    their own names: ``load_state_dict`` is strict), on the CPU."""
    cfg, state = load_sam_state(path, config)
    model = Sam(cfg)
    model.load_state_dict(state)
    return model


def _flax_sources(cfg: SamConfig):
    """(torch key, Flax path, layout) of every tensor of :class:`Sam`, as
    ``nsof_tpu.models.sam.convert_sam`` lays them out.  Layouts: 'dense'
    (transposed), 'conv' (HWIO → OIHW), 'convT' (``[kh, kw, Ci, Co]`` →
    ``[Ci, Co, kh, kw]``), 'row<i>' (one row of a stacked table), 'plain'."""
    out = []

    def dense(key, path, bias=True):
        out.append((f"{key}.weight", path + ("kernel",), "dense"))
        if bias:
            out.append((f"{key}.bias", path + ("bias",), "plain"))

    def conv(key, path, bias=True):
        out.append((f"{key}.weight", path + ("kernel",), "conv"))
        if bias:
            out.append((f"{key}.bias", path + ("bias",), "plain"))

    def ln(key, path):
        out.append((f"{key}.weight", path + ("scale",), "plain"))
        out.append((f"{key}.bias", path + ("bias",), "plain"))

    enc = ("image_encoder", "params")
    conv("image_encoder.patch_embed.proj", enc + ("patch_embed",))
    out.append(("image_encoder.pos_embed", enc + ("pos_embed",), "plain"))
    for i in range(cfg.depth):
        p, f = f"image_encoder.blocks.{i}", enc + (f"block{i}",)
        ln(f"{p}.norm1", f + ("norm1",))
        ln(f"{p}.norm2", f + ("norm2",))
        dense(f"{p}.attn.qkv", f + ("attn", "qkv"))
        dense(f"{p}.attn.proj", f + ("attn", "proj"))
        out.append((f"{p}.attn.rel_pos_h", f + ("attn", "rel_pos_h"), "plain"))
        out.append((f"{p}.attn.rel_pos_w", f + ("attn", "rel_pos_w"), "plain"))
        dense(f"{p}.mlp.lin1", f + ("mlp_lin1",))
        dense(f"{p}.mlp.lin2", f + ("mlp_lin2",))
    conv("image_encoder.neck.0", enc + ("neck0",), bias=False)
    ln("image_encoder.neck.1", enc + ("neck1",))
    conv("image_encoder.neck.2", enc + ("neck2",), bias=False)
    ln("image_encoder.neck.3", enc + ("neck3",))

    pe, fp = "prompt_encoder", ("prompt_encoder", "params")
    out.append((f"{pe}.pe_layer.positional_encoding_gaussian_matrix", fp + ("pe_gaussian",),
                "plain"))
    for i in range(4):
        out.append((f"{pe}.point_embeddings.{i}.weight", fp + ("point_embed",), f"row{i}"))
    out.append((f"{pe}.not_a_point_embed.weight", fp + ("not_a_point",), "plain"))
    out.append((f"{pe}.no_mask_embed.weight", fp + ("no_mask",), "plain"))
    conv(f"{pe}.mask_downscaling.0", fp + ("mask_conv1",))
    ln(f"{pe}.mask_downscaling.1", fp + ("mask_ln1",))
    conv(f"{pe}.mask_downscaling.3", fp + ("mask_conv2",))
    ln(f"{pe}.mask_downscaling.4", fp + ("mask_ln2",))
    conv(f"{pe}.mask_downscaling.6", fp + ("mask_conv3",))

    md, fd = "mask_decoder", ("mask_decoder", "params")
    out.append((f"{md}.iou_token.weight", fd + ("iou_token",), "plain"))
    out.append((f"{md}.mask_tokens.weight", fd + ("mask_tokens",), "plain"))
    out.append((f"{md}.output_upscaling.0.weight", fd + ("up1_kernel",), "convT"))
    out.append((f"{md}.output_upscaling.0.bias", fd + ("up1_bias",), "plain"))
    ln(f"{md}.output_upscaling.1", fd + ("up_ln",))
    out.append((f"{md}.output_upscaling.3.weight", fd + ("up2_kernel",), "convT"))
    out.append((f"{md}.output_upscaling.3.bias", fd + ("up2_bias",), "plain"))
    tr = fd + ("transformer",)

    def attn(key, path):
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            dense(f"{key}.{name}", path + (name,))

    for i in range(cfg.decoder_depth):
        p, f = f"{md}.transformer.layers.{i}", tr + (f"layer{i}",)
        attn(f"{p}.self_attn", f + ("self_attn",))
        attn(f"{p}.cross_attn_token_to_image", f + ("cross_t2i",))
        attn(f"{p}.cross_attn_image_to_token", f + ("cross_i2t",))
        for j in range(1, 5):
            ln(f"{p}.norm{j}", f + (f"norm{j}",))
        dense(f"{p}.mlp.lin1", f + ("mlp_lin1",))
        dense(f"{p}.mlp.lin2", f + ("mlp_lin2",))
    attn(f"{md}.transformer.final_attn_token_to_image", tr + ("final_attn",))
    ln(f"{md}.transformer.norm_final_attn", tr + ("norm_final",))
    for i in range(cfg.num_mask_tokens):
        for j in range(3):
            dense(f"{md}.output_hypernetworks_mlps.{i}.layers.{j}", fd + (f"hyper{i}", f"lin{j}"))
    for j in range(3):
        dense(f"{md}.iou_prediction_head.layers.{j}", fd + ("iou_head", f"lin{j}"))
    return out


def params_from_jax(params: Mapping[str, Any], config: SamConfig) -> dict[str, torch.Tensor]:
    """The JAX package's Flax tree of ``convert_sam`` (``{'image_encoder':
    {'params': ...}, 'prompt_encoder': ..., 'mask_decoder': ...}``, as
    numpy arrays) → a state dict of the port's :class:`Sam`.  Raises
    ``ValueError`` on a missing or unused tensor or a shape that differs."""
    state, used, errors = {}, set(), []
    for key, path, layout in _flax_sources(config):
        node = params
        try:
            for p in path:
                node = node[p]
        except KeyError:
            errors.append(f"{key}: no Flax source {'/'.join(path)}")
            continue
        used.add(path)
        a = np.array(node, dtype=np.float32)
        if layout == "dense":
            a = a.T
        elif layout == "conv":
            a = a.transpose(3, 2, 0, 1)
        elif layout == "convT":
            a = a.transpose(2, 3, 0, 1)
        elif layout.startswith("row"):
            i = int(layout[3:])
            a = a[i : i + 1]
        state[key] = torch.from_numpy(np.ascontiguousarray(a))

    def leaves(node, prefix=()):
        if isinstance(node, Mapping):
            for k, v in node.items():
                yield from leaves(v, prefix + (k,))
        else:
            yield prefix

    errors += [f"{'/'.join(p)}: unused Flax parameter" for p in leaves(params) if p not in used]
    target = Sam(config).state_dict()
    errors += [f"{k}: shape {tuple(state[k].shape)} != {tuple(v.shape)}"
               for k, v in target.items() if k in state and state[k].shape != v.shape]
    if errors:
        raise ValueError("SAM parameter conversion:\n" + "\n".join(errors))
    return state


def synthetic_sam_state_dict(config: SamConfig = TINY_SAM, seed: int = 0) -> dict[str, np.ndarray]:
    """Random weights with the official checkpoint's keys and shapes for
    ``config``, drawn as the JAX package's ``synthetic_sam_state_dict``
    draws them (the same numpy draws in the same order): N(0, 0.05) float32
    for every tensor."""
    rng = np.random.default_rng(seed)
    out: dict[str, np.ndarray] = {}

    def add(key, *shape):
        out[key] = rng.normal(0, 0.05, shape).astype(np.float32)

    cfg = config
    d, pd = cfg.embed_dim, cfg.prompt_dim
    s = cfg.embedding_size
    add("image_encoder.patch_embed.proj.weight", d, 3, cfg.patch_size, cfg.patch_size)
    add("image_encoder.patch_embed.proj.bias", d)
    add("image_encoder.pos_embed", 1, s, s, d)
    hd = d // cfg.num_heads
    for i in range(cfg.depth):
        p = f"image_encoder.blocks.{i}"
        add(f"{p}.norm1.weight", d)
        add(f"{p}.norm1.bias", d)
        add(f"{p}.norm2.weight", d)
        add(f"{p}.norm2.bias", d)
        add(f"{p}.attn.qkv.weight", 3 * d, d)
        add(f"{p}.attn.qkv.bias", 3 * d)
        add(f"{p}.attn.proj.weight", d, d)
        add(f"{p}.attn.proj.bias", d)
        size = s if i in cfg.global_attn_indexes else cfg.window_size
        add(f"{p}.attn.rel_pos_h", 2 * size - 1, hd)
        add(f"{p}.attn.rel_pos_w", 2 * size - 1, hd)
        add(f"{p}.mlp.lin1.weight", 4 * d, d)
        add(f"{p}.mlp.lin1.bias", 4 * d)
        add(f"{p}.mlp.lin2.weight", d, 4 * d)
        add(f"{p}.mlp.lin2.bias", d)
    add("image_encoder.neck.0.weight", pd, d, 1, 1)
    add("image_encoder.neck.1.weight", pd)
    add("image_encoder.neck.1.bias", pd)
    add("image_encoder.neck.2.weight", pd, pd, 3, 3)
    add("image_encoder.neck.3.weight", pd)
    add("image_encoder.neck.3.bias", pd)

    pe = "prompt_encoder"
    add(f"{pe}.pe_layer.positional_encoding_gaussian_matrix", 2, pd // 2)
    for i in range(4):
        add(f"{pe}.point_embeddings.{i}.weight", 1, pd)
    add(f"{pe}.not_a_point_embed.weight", 1, pd)
    add(f"{pe}.no_mask_embed.weight", 1, pd)
    mc = cfg.mask_in_chans
    add(f"{pe}.mask_downscaling.0.weight", mc // 4, 1, 2, 2)
    add(f"{pe}.mask_downscaling.0.bias", mc // 4)
    add(f"{pe}.mask_downscaling.1.weight", mc // 4)
    add(f"{pe}.mask_downscaling.1.bias", mc // 4)
    add(f"{pe}.mask_downscaling.3.weight", mc, mc // 4, 2, 2)
    add(f"{pe}.mask_downscaling.3.bias", mc)
    add(f"{pe}.mask_downscaling.4.weight", mc)
    add(f"{pe}.mask_downscaling.4.bias", mc)
    add(f"{pe}.mask_downscaling.6.weight", pd, mc, 1, 1)
    add(f"{pe}.mask_downscaling.6.bias", pd)

    md = "mask_decoder"
    nm = cfg.num_mask_tokens
    add(f"{md}.iou_token.weight", 1, pd)
    add(f"{md}.mask_tokens.weight", nm, pd)
    for i in range(cfg.decoder_depth):
        p = f"{md}.transformer.layers.{i}"
        for a, ds in (("self_attn", 1), ("cross_attn_token_to_image", 2),
                      ("cross_attn_image_to_token", 2)):
            inner = pd // ds
            for nmn in ("q_proj", "k_proj", "v_proj"):
                add(f"{p}.{a}.{nmn}.weight", inner, pd)
                add(f"{p}.{a}.{nmn}.bias", inner)
            add(f"{p}.{a}.out_proj.weight", pd, inner)
            add(f"{p}.{a}.out_proj.bias", pd)
        for j in range(1, 5):
            add(f"{p}.norm{j}.weight", pd)
            add(f"{p}.norm{j}.bias", pd)
        add(f"{p}.mlp.lin1.weight", cfg.decoder_mlp_dim, pd)
        add(f"{p}.mlp.lin1.bias", cfg.decoder_mlp_dim)
        add(f"{p}.mlp.lin2.weight", pd, cfg.decoder_mlp_dim)
        add(f"{p}.mlp.lin2.bias", pd)
    fp = f"{md}.transformer.final_attn_token_to_image"
    for nmn in ("q_proj", "k_proj", "v_proj"):
        add(f"{fp}.{nmn}.weight", pd // 2, pd)
        add(f"{fp}.{nmn}.bias", pd // 2)
    add(f"{fp}.out_proj.weight", pd, pd // 2)
    add(f"{fp}.out_proj.bias", pd)
    add(f"{md}.transformer.norm_final_attn.weight", pd)
    add(f"{md}.transformer.norm_final_attn.bias", pd)
    add(f"{md}.output_upscaling.0.weight", pd, pd // 4, 2, 2)
    add(f"{md}.output_upscaling.0.bias", pd // 4)
    add(f"{md}.output_upscaling.1.weight", pd // 4)
    add(f"{md}.output_upscaling.1.bias", pd // 4)
    add(f"{md}.output_upscaling.3.weight", pd // 4, pd // 8, 2, 2)
    add(f"{md}.output_upscaling.3.bias", pd // 8)
    for i in range(nm):
        p = f"{md}.output_hypernetworks_mlps.{i}"
        add(f"{p}.layers.0.weight", pd, pd)
        add(f"{p}.layers.0.bias", pd)
        add(f"{p}.layers.1.weight", pd, pd)
        add(f"{p}.layers.1.bias", pd)
        add(f"{p}.layers.2.weight", pd // 8, pd)
        add(f"{p}.layers.2.bias", pd // 8)
    add(f"{md}.iou_prediction_head.layers.0.weight", 256, pd)
    add(f"{md}.iou_prediction_head.layers.0.bias", 256)
    add(f"{md}.iou_prediction_head.layers.1.weight", 256, 256)
    add(f"{md}.iou_prediction_head.layers.1.bias", 256)
    add(f"{md}.iou_prediction_head.layers.2.weight", nm, 256)
    add(f"{md}.iou_prediction_head.layers.2.bias", nm)
    return out


# ---------------------------------------------------------------------------
# predictor (the SamPredictor capability, predictor.py + sam.py:133-174)
# ---------------------------------------------------------------------------


def preprocess_shape(h: int, w: int, target: int) -> tuple[int, int]:
    """Longest side → target (transforms.py get_preprocess_shape)."""
    scale = target / max(h, w)
    return int(h * scale + 0.5), int(w * scale + 0.5)


class SamPredictor:
    """Image-at-a-time promptable segmentation, the JAX ``SamPredictor``'s
    counterpart.

    :meth:`set_image` resizes the longest side to ``img_size``
    (``cv2.resize(INTER_LINEAR)``'s arithmetic, :func:`resize_linear`, on the
    host), uploads the uint8 image, normalises and zero-pads it to a square
    on the device and runs the encoder once.  :meth:`predict` embeds box and
    point prompts, decodes and resizes the logits back to the frame.  Takes a
    :class:`Sam` holding its weights; runs on ``device`` (default the CUDA
    device; raises ``RuntimeError`` without one unless ``device='cpu'``)."""

    def __init__(self, model: Sam, device=None):
        self.device = _build.resolve_device(device)
        self.model = model.to(self.device).eval().requires_grad_(False)
        self.config = model.config
        self._mean = torch.tensor(PIXEL_MEAN, dtype=torch.float32, device=self.device)
        self._std = torch.tensor(PIXEL_STD, dtype=torch.float32, device=self.device)
        self._embedding = None
        self._input_size = None
        self._orig_size = None

    def preprocess(self, image_rgb: np.ndarray) -> torch.Tensor:
        """uint8 ``[H, W, 3]`` RGB → the encoder's ``[1, 3, S, S]`` input on
        the device: the longest side resized to ``img_size`` on the host, the
        uint8 upload normalised and zero-padded to the square."""
        tgt = self.config.img_size
        nh, nw = preprocess_shape(*image_rgb.shape[:2], tgt)
        resized = resize_linear(np.ascontiguousarray(image_rgb), nw, nh)
        x = (torch.from_numpy(resized).to(self.device).to(torch.float32) - self._mean) / self._std
        return F.pad(x.permute(2, 0, 1), (0, tgt - nw, 0, tgt - nh))[None]

    def set_image(self, image_rgb: np.ndarray) -> None:
        h0, w0 = image_rgb.shape[:2]
        x = self.preprocess(image_rgb)
        with torch.inference_mode():
            self._embedding = self.model.image_encoder(x)
        self._input_size = preprocess_shape(h0, w0, self.config.img_size)
        self._orig_size = (h0, w0)

    def _transform_coords(self, coords: np.ndarray) -> np.ndarray:
        h0, w0 = self._orig_size
        nh, nw = self._input_size
        out = np.asarray(coords, np.float32).copy()
        out[..., 0] *= nw / w0
        out[..., 1] *= nh / h0
        return out

    def predict(self, boxes: Optional[np.ndarray] = None,
                point_coords: Optional[np.ndarray] = None,
                point_labels: Optional[np.ndarray] = None,
                mask_input: Optional[np.ndarray] = None,
                multimask_output: bool = False, return_logits: bool = False):
        """Prompts in ORIGINAL image coordinates (boxes ``[B, 4]`` xyxy,
        points ``[B, P, 2]`` with labels ``[B, P]``, a mask ``[B, 1, 4S,
        4S]`` of low-res logits) → numpy (masks ``[B, C, H0, W0]`` bool, or
        float logits with ``return_logits``; IoU ``[B, C]``; low-res logits
        ``[B, C, 4S, 4S]``)."""
        if self._embedding is None:
            raise RuntimeError("call set_image first")
        dev = self.device
        coords = labels = bxs = m_in = None
        if point_coords is not None:
            coords = torch.from_numpy(self._transform_coords(point_coords)).to(dev)
            labels = torch.as_tensor(np.asarray(point_labels), dtype=torch.int32, device=dev)
        if boxes is not None:
            b = self._transform_coords(np.asarray(boxes, np.float32).reshape(-1, 2, 2))
            bxs = torch.from_numpy(b.reshape(-1, 4)).to(dev)
        if mask_input is not None:
            m_in = torch.as_tensor(np.asarray(mask_input, np.float32), device=dev)
        m = self.model
        with torch.inference_mode():
            sparse, dense = m.prompt_encoder(coords, labels, bxs, m_in)
            low_res, iou = m.mask_decoder(self._embedding, m.prompt_encoder.get_dense_pe(),
                                          sparse, dense)
        sl = slice(1, None) if multimask_output else slice(0, 1)  # C masks: 3, or the first
        low_res, iou = low_res[:, sl], iou[:, sl]
        masks = self.postprocess(low_res)
        if not return_logits:
            masks = masks > MASK_THRESHOLD
        return masks.cpu().numpy(), iou.cpu().numpy(), low_res.cpu().numpy()

    def postprocess(self, low_res: torch.Tensor) -> torch.Tensor:
        """Low-res logits → the original frame's logits (sam.py:133-162):
        linear (JAX's weights, antialiased when shrinking) to ``img_size``,
        the un-padded region cropped, linear to the original size."""
        tgt = self.config.img_size
        nh, nw = self._input_size
        up = resize(low_res, (tgt, tgt), "linear")[..., :nh, :nw]
        return resize(up, self._orig_size, "linear")
