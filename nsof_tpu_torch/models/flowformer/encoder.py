"""FlowFormer memory encoder in PyTorch: cost volume → latent cost tokens.
The port of :mod:`nsof_tpu.models.flowformer.encoder`.

Per source pixel, the H2×W2 cost map is patch-embedded to 1/8 tokens with
linear-sine positional encodings, cross-attended into K latent tokens, then
refined by self-attention among the tokens and by "vertical" attention
across source pixels (a local ws = 7 block, then a global sub-sampled one,
each conditioned on the context features) — MemoryEncoder and
CostPerceiverEncoder (FlowFormer-Official core/FlowFormer/LatentCostFormer/
encoder.py:240-367).  Modules carry the reference's torch names
(``cost_perceiver_encoder.patch_embed.proj.0``,
``vertical_encoder_layers.0.global_block.attn.sr_key``, ...).  Tokens are
channels-last, as in the JAX model.

As in the JAX model (which says why), batch items pair context and tokens
b-major, where the reference misaligns them for a batch of more than one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from einops import rearrange
from torch import nn

from nsof_tpu_torch.models.flowformer.config import FlowFormerConfig
from nsof_tpu_torch.models.flowformer.twins import (Mlp, SameConv2d, TwinsSVTLarge2Stage,
                                                    attend, conv_nhwc)


def linear_position_embedding(coords: torch.Tensor, dim: int) -> torch.Tensor:
    """LinearPositionEmbeddingSine (attention.py:150-154): sin and cos ramps
    of 3.14·coord·k/200 for k < dim/4; ``coords`` ``[..., 2]`` as (x, y)."""
    freqs = torch.arange(dim // 4, dtype=torch.float32, device=coords.device) / 200.0
    x = coords[..., 0:1] * freqs
    y = coords[..., 1:2] * freqs
    pi = 3.14
    return torch.cat([torch.sin(pi * x), torch.cos(pi * x), torch.sin(pi * y),
                      torch.cos(pi * y)], dim=-1)


def grid_pe(h: int, w: int, dim: int, scale: float = 1.0, device=None) -> torch.Tensor:
    """``[h, w, dim]`` position embedding of the (x, y) grid × ``scale``."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device) * scale,
                            torch.arange(w, dtype=torch.float32, device=device) * scale,
                            indexing="ij")
    return linear_position_embedding(torch.stack([xs, ys], dim=-1), dim)


def multi_head_attention(q, k, v, dim: int, heads: int) -> torch.Tensor:
    """Plain multi-head attention over given projections ``[B, N, heads·d]``
    (attention.py:37-62), scale (dim / heads)^-0.5."""
    split = "b i (h d) -> b h i d"
    out = attend(rearrange(q, split, h=heads), rearrange(k, split, h=heads),
                 rearrange(v, split, h=heads), (dim / heads) ** -0.5)
    return rearrange(out, "b h i d -> b i (h d)")


def _ffn(dim: int) -> nn.Sequential:
    """Linear → GELU → Dropout → Linear → Dropout, dropout off: the
    reference's ``ffn`` (its Linears at indices 0 and 3)."""
    return nn.Sequential(nn.Linear(dim, dim), nn.GELU(), nn.Dropout(0.0), nn.Linear(dim, dim),
                         nn.Dropout(0.0))


class CostPatchEmbed(nn.Module):
    """Patch-embed cost maps ``[N, heads, H2, W2]`` to 1/8 tokens with a
    coordinate FFN (encoder.py PatchEmbed, patch size 8) → ``([N, h3·w3,
    2·dim], (h3, w3))``."""

    def __init__(self, heads: int, dim: int):
        super().__init__()
        self.dim = dim
        self.proj = nn.Sequential(
            nn.Conv2d(heads, dim // 4, 6, 2, 2), nn.ReLU(),
            nn.Conv2d(dim // 4, dim // 2, 6, 2, 2), nn.ReLU(),
            nn.Conv2d(dim // 2, dim, 6, 2, 2))
        self.ffn_with_coord = nn.Sequential(nn.Conv2d(2 * dim, 2 * dim, 1), nn.ReLU(),
                                            nn.Conv2d(2 * dim, 2 * dim, 1))
        self.norm = nn.LayerNorm(2 * dim, eps=1e-5)

    def forward(self, cost):
        n, _, h2, w2 = cost.shape
        x = self.proj(F.pad(cost, (0, (-w2) % 8, 0, (-h2) % 8)))
        h3, w3 = x.shape[-2:]
        # the grid's centres: coordinate 8·i + 4
        ys, xs = torch.meshgrid(torch.arange(h3, dtype=torch.float32, device=x.device) * 8.0 + 4.0,
                                torch.arange(w3, dtype=torch.float32, device=x.device) * 8.0 + 4.0,
                                indexing="ij")
        pe = linear_position_embedding(torch.stack([xs, ys], dim=-1), self.dim)
        pe = pe.permute(2, 0, 1)[None].expand(n, -1, -1, -1).to(x.dtype)
        x = self.ffn_with_coord(torch.cat([x, pe], dim=1))
        return self.norm(x.flatten(2).transpose(1, 2)), (h3, w3)


class AttentionLayer(nn.Module):
    """A pre-norm attention layer: ``query`` attends into ``target`` (or
    into itself), then the FFN (encoder.py:162-168, 218-224)."""

    def __init__(self, query_dim: int, target_dim: int, heads: int = 8):
        super().__init__()
        self.dim, self.heads = query_dim, heads
        self.norm1 = nn.LayerNorm(query_dim, eps=1e-5)
        self.q = nn.Linear(query_dim, query_dim)
        self.k = nn.Linear(target_dim, query_dim)
        self.v = nn.Linear(target_dim, query_dim)
        self.proj = nn.Linear(query_dim, query_dim)
        self.norm2 = nn.LayerNorm(query_dim, eps=1e-5)
        self.ffn = _ffn(query_dim)

    def forward(self, query, target=None):
        qn = self.norm1(query)
        # self-attention takes k and v from the normalised tokens
        target = qn if target is None else target
        x = multi_head_attention(self.q(qn), self.k(target), self.v(target), self.dim,
                                 self.heads)
        x = query + self.proj(x)
        return x + self.ffn(self.norm2(x))


class _VerticalAttn(nn.Module):
    def __init__(self, d: int, vert_c_dim: int, sr_ratio: int = 1):
        super().__init__()
        d_qk = d + vert_c_dim
        self.context_proj = nn.Linear(256, vert_c_dim)
        self.q = nn.Linear(d_qk, d)
        if sr_ratio > 1:
            self.sr_key = SameConv2d(d_qk, d, sr_ratio, sr_ratio)
            self.sr_value = SameConv2d(d, d, sr_ratio, sr_ratio)
            # one LayerNorm for both sr outputs (twins.py:368-372)
            self.norm = nn.LayerNorm(d, eps=1e-5)
            self.k = nn.Linear(d, d)
        else:
            self.k = nn.Linear(d_qk, d)
        self.v = nn.Linear(d, d)
        self.proj = nn.Linear(d, d)


class _VerticalBlock(nn.Module):
    """One context-conditioned block of :class:`VerticalAttentionLayer`:
    the local window block (``sr_ratio=1``) or the global sub-sampled one."""

    def __init__(self, d: int, vert_c_dim: int, heads: int, ws: int, sr_ratio: int):
        super().__init__()
        self.d, self.heads, self.ws, self.sr = d, heads, ws, sr_ratio
        self.norm1 = nn.LayerNorm(d, eps=1e-5)
        self.attn = _VerticalAttn(d, vert_c_dim, sr_ratio)
        self.norm2 = nn.LayerNorm(d, eps=1e-5)
        self.mlp = Mlp(d, 4 * d, d)

    def forward(self, x, context):
        bk, h1, w1, d = x.shape
        a = self.attn
        ctx = a.context_proj(context).repeat_interleave(bk // context.shape[0], dim=0)
        xn = self.norm1(x)
        x_qk = torch.cat([xn, ctx.to(xn.dtype)], dim=-1)
        step = self.ws if self.sr == 1 else self.sr
        pads = (0, 0, 0, (-w1) % step, 0, (-h1) % step)
        xq, xv = F.pad(x_qk, pads), F.pad(xn, pads)
        hp, wp = xq.shape[1:3]
        scale = (d // self.heads) ** -0.5
        if self.sr == 1:
            # within-window position embedding, the same for every window
            pe = grid_pe(self.ws, self.ws, x_qk.shape[-1], device=x.device)
            xq = xq + pe.repeat(hp // self.ws, wp // self.ws, 1)[None].to(xq.dtype)
            win = "b (nh wa) (nw wb) (h dd) -> (b nh nw) h (wa wb) dd"
            q, k, v = (rearrange(t, win, wa=self.ws, wb=self.ws, h=self.heads)
                       for t in (a.q(xq), a.k(xq), a.v(xv)))
            out = rearrange(attend(q, k, v, scale),
                            "(b nh nw) h (wa wb) dd -> b (nh wa) (nw wb) (h dd)",
                            b=bk, nh=hp // self.ws, wa=self.ws)
        else:
            q = a.q(xq + grid_pe(hp, wp, x_qk.shape[-1], device=x.device)[None].to(xq.dtype))
            ks = a.norm(conv_nhwc(a.sr_key, xq))
            vs = a.norm(conv_nhwc(a.sr_value, xv))
            ks = ks + grid_pe(hp // self.sr, wp // self.sr, d, float(self.sr),
                              device=x.device)[None].to(ks.dtype)
            heads = "b x y (h dd) -> b h (x y) dd"
            out = attend(rearrange(q, heads, h=self.heads), rearrange(a.k(ks), heads, h=self.heads),
                         rearrange(a.v(vs), heads, h=self.heads), scale)
            out = rearrange(out, "b h (x y) dd -> b x y (h dd)", x=hp)
        x = x + a.proj(out[:, :h1, :w1])
        return x + self.mlp(self.norm2(x))


class VerticalAttentionLayer(nn.Module):
    """Attention across source pixels per latent token: a local window
    block, then a global sub-sampled block, both context-conditioned
    (VerticalSelfAttentionLayer, encoder.py:108-135)."""

    def __init__(self, dim: int, vert_c_dim: int, heads: int = 8, ws: int = 7,
                 sr_ratio: int = 4):
        super().__init__()
        self.local_block = _VerticalBlock(dim, vert_c_dim, heads, ws, 1)
        self.global_block = _VerticalBlock(dim, vert_c_dim, heads, ws, sr_ratio)

    def forward(self, x, context):
        return self.global_block(self.local_block(x, context), context)


class CostPerceiverEncoder(nn.Module):
    def __init__(self, cfg: FlowFormerConfig):
        super().__init__()
        c = self.cfg = cfg
        self.patch_embed = CostPatchEmbed(c.cost_heads_num, c.cost_latent_input_dim)
        self.latent_tokens = nn.Parameter(torch.randn(1, c.cost_latent_token_num,
                                                      c.cost_latent_dim))
        self.input_layer = AttentionLayer(c.cost_latent_dim, 2 * c.cost_latent_input_dim)
        self.encoder_layers = nn.ModuleList(
            AttentionLayer(c.cost_latent_dim, c.cost_latent_dim) for _ in range(c.encoder_depth))
        self.vertical_encoder_layers = nn.ModuleList(
            VerticalAttentionLayer(c.cost_latent_dim, c.vert_c_dim)
            for _ in range(c.encoder_depth))

    def forward(self, cost_maps, context, b: int, h1: int, w1: int):
        """``cost_maps`` ``[B·H1·W1, heads, H2, W2]``; ``context`` ``[B, H1,
        W1, 256]`` → cost memory ``[B·H1·W1, K, D]``."""
        x, _ = self.patch_embed(cost_maps)
        latents = self.latent_tokens.expand(x.shape[0], -1, -1).to(x.dtype)
        x = self.input_layer(latents, x)
        short_cut = x
        k = self.cfg.cost_latent_token_num
        for layer, vert in zip(self.encoder_layers, self.vertical_encoder_layers):
            x = layer(x)
            x = rearrange(x, "(b h1 w1) k d -> (b k) h1 w1 d", b=b, h1=h1, w1=w1)
            x = vert(x, context)
            x = rearrange(x, "(b k) h1 w1 d -> (b h1 w1) k d", b=b, k=k)
        return x + short_cut if self.cfg.cost_encoder_res else x


class MemoryEncoder(nn.Module):
    """Features of both frames (:meth:`features`), then their cost volume
    (not scaled by 1/√d, encoder.py:341-352) and its latent tokens."""

    def __init__(self, cfg: FlowFormerConfig):
        super().__init__()
        from nsof_tpu_torch.models.raft import BasicEncoder

        self.cfg = cfg
        self.feat_encoder = (TwinsSVTLarge2Stage(cfg.gsa_pad) if cfg.fnet == "twins"
                             else BasicEncoder(256, "instance"))
        self.channel_convertor = nn.Conv2d(256, cfg.encoder_latent_dim, 1, bias=False)
        self.cost_perceiver_encoder = CostPerceiverEncoder(cfg)

    def features(self, imgs):
        """``imgs`` ``[2B, H, W, 3]`` (both frames) → their converted
        features ``[2B, H1, W1, C]``."""
        if self.cfg.fnet == "twins":
            feats = self.feat_encoder(imgs)
        else:
            feats = self.feat_encoder(imgs.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return conv_nhwc(self.channel_convertor, feats)

    def forward(self, feats, context):
        """:meth:`features`' output and ``context`` ``[B, H1, W1, 256]`` →
        (cost memory ``[B·H1·W1, K, D]``, cost maps ``[B·H1·W1, heads, H1,
        W1]``)."""
        c = self.cfg
        b = context.shape[0]
        _, h1, w1, ch = feats.shape
        heads = c.cost_heads_num
        f1 = feats[:b].reshape(b, h1 * w1, heads, ch // heads).transpose(1, 2)
        f2 = feats[b:].reshape(b, h1 * w1, heads, ch // heads).transpose(1, 2)
        cost = torch.matmul(f1.float(), f2.float().transpose(-1, -2))  # [B, heads, N, N]
        cost_maps = cost.reshape(b, heads, h1, w1, h1, w1).permute(0, 2, 3, 1, 4, 5)
        cost_maps = cost_maps.reshape(b * h1 * w1, heads, h1, w1)
        return self.cost_perceiver_encoder(cost_maps, context, b, h1, w1), cost_maps
