"""FlowFormer memory decoder in PyTorch: recurrent flow queries over the
cost memory.  The port of :mod:`nsof_tpu.models.flowformer.decoder`.

Per refinement step (MemoryDecoder, FlowFormer-Official core/FlowFormer/
LatentCostFormer/decoder.py:146-260): a 9×9 cost window is sampled at the
current coordinates (r = 4), a flow-token query cross-attends into the
latent cost memory, and a GMA-augmented SepConvGRU updates the hidden state
and the flow, with convex 8× upsampling.  The default depth is 32
(things_eval.py:52).  The update block is NCHW, the attention channels-last.
In test mode the flow is upsampled once, after the last step.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from einops import rearrange
from torch import nn

from nsof_tpu_torch.models.flowformer.config import FlowFormerConfig
from nsof_tpu_torch.models.flowformer.encoder import (_ffn, linear_position_embedding,
                                                      multi_head_attention)
from nsof_tpu_torch.models.raft import (BasicMotionEncoder, FlowHead, SepConvGRU, _conv,
                                        coords_grid, corr_lookup, upsample_flow_convex)


class GMAAttention(nn.Module):
    """The global motion aggregation's attention map from the context
    features (gma.py Attention: content only, 1 head, dim_head 128) →
    ``[B, heads, N, N]``."""

    def __init__(self, dim: int = 128, heads: int = 1, dim_head: int = 128):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.to_qk = nn.Conv2d(dim, 2 * heads * dim_head, 1, bias=False)

    def forward(self, fmap):
        q, k = self.to_qk(fmap).chunk(2, dim=1)
        q, k = (rearrange(t, "b (h d) x y -> b h (x y) d", h=self.heads) for t in (q, k))
        return torch.softmax(torch.matmul(q * self.dim_head ** -0.5, k.transpose(-1, -2)), dim=-1)


class GMAAggregate(nn.Module):
    """Motion features plus ``gamma`` × their attention-weighted sum
    (gma.py Aggregate)."""

    def __init__(self, dim: int = 128, heads: int = 1, dim_head: int = 128):
        super().__init__()
        self.heads = heads
        self.to_v = nn.Conv2d(dim, heads * dim_head, 1, bias=False)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, attn, fmap):
        h = fmap.shape[2]
        v = rearrange(self.to_v(fmap), "b (h d) x y -> b h (x y) d", h=self.heads)
        out = rearrange(torch.matmul(attn.to(v.dtype), v), "b h (x y) d -> b (h d) x y", x=h)
        return fmap + self.gamma.to(fmap.dtype) * out


class GMAUpdateBlock(nn.Module):
    """SepConvGRU update with GMA-aggregated motion features (gru.py
    GMAUpdateBlock); the motion encoder takes 81 + query_latent_dim cost
    channels."""

    def __init__(self, cor_planes: int):
        super().__init__()
        self.encoder = BasicMotionEncoder(cor_planes)
        self.aggregator = GMAAggregate()
        self.gru = SepConvGRU(128, 3 * 128)
        self.flow_head = FlowHead(128, 256)
        self.mask = nn.Sequential(_conv(128, 256, 3), nn.ReLU(), nn.Conv2d(256, 64 * 9, 1))

    def forward(self, net, inp, corr, flow, attention):
        motion = self.encoder(flow, corr)
        motion_global = self.aggregator(attention, motion)
        net = self.gru(net, torch.cat([inp, motion, motion_global], dim=1))
        return net, 0.25 * self.mask(net), self.flow_head(net)


class DecoderCrossAttention(nn.Module):
    """Flow-token query → cost-memory cross attention with a positional
    encoding of the query's coordinates (decoder.py CrossAttentionLayer).
    ``k`` and ``v`` project the cost memory once, before the steps."""

    def __init__(self, cfg: FlowFormerConfig):
        super().__init__()
        dim = self.dim = cfg.query_latent_dim
        self.add_flow_token = cfg.add_flow_token
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(cfg.cost_latent_dim, dim)
        self.v = nn.Linear(cfg.cost_latent_dim, dim)
        self.proj = nn.Linear(2 * dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.ffn = _ffn(dim)

    def forward(self, query, key, value, coords1):
        b, h1, w1, _ = coords1.shape
        qc_enc = linear_position_embedding(coords1.reshape(b * h1 * w1, 1, 2), self.dim)
        qn = self.norm1(query)
        q = self.q(qn + qc_enc.to(qn.dtype) if self.add_flow_token else qc_enc.to(qn.dtype))
        x = multi_head_attention(q, key, value, self.dim, 8)
        x = query + self.proj(torch.cat([x, query], dim=-1))
        return x + self.ffn(self.norm2(x))


class _DecoderLayer(nn.Module):
    def __init__(self, cfg: FlowFormerConfig):
        super().__init__()
        self.cross_attend = DecoderCrossAttention(cfg)


class MemoryDecoder(nn.Module):
    def __init__(self, cfg: FlowFormerConfig):
        super().__init__()
        c = self.cfg = cfg
        dim = c.query_latent_dim
        self.flow_token_encoder = nn.Sequential(nn.Conv2d(81 * c.cost_heads_num, dim, 1),
                                                nn.GELU(), nn.Conv2d(dim, dim, 1))
        self.proj = nn.Conv2d(256, 256, 1)
        self.decoder_layer = _DecoderLayer(cfg)
        if c.use_gma:
            self.att = GMAAttention()
        self.update_block = GMAUpdateBlock(dim if c.only_global else dim + 81)

    def forward(self, cost_memory, context, cost_maps, flow_init=None, test_mode: bool = False):
        """``cost_memory`` ``[B·H1·W1, K, D]``; ``context`` ``[B, H1, W1,
        256]``; ``cost_maps`` ``[B·H1·W1, 1, H2, W2]``.  Returns the list of
        per-step upsampled flows ``[B, H, W, 2]``, or in ``test_mode`` the
        last."""
        c = self.cfg
        dim = c.query_latent_dim
        b, h1, w1, _ = context.shape
        ctx = self.proj(context.permute(0, 3, 1, 2))
        net = torch.tanh(ctx[:, :128])
        inp = F.relu(ctx[:, 128:])
        attention = self.att(inp) if c.use_gma else None
        coords0 = coords_grid(b, h1, w1, context.device)
        coords1 = coords0.clone()
        if flow_init is not None:
            coords1 = coords1 + flow_init
        cross = self.decoder_layer.cross_attend
        key, value = cross.k(cost_memory), cross.v(cost_memory)
        cm = [cost_maps[:, 0]]
        flows, up_mask = [], None
        for _ in range(c.decoder_depth):
            coords1 = coords1.detach()
            cost_forward = corr_lookup(cm, coords1, 4)  # [B, H1, W1, 81]
            query = self.flow_token_encoder(cost_forward.permute(0, 3, 1, 2))
            query = query.permute(0, 2, 3, 1).reshape(b * h1 * w1, 1, dim)
            cost_global = cross(query, key, value, coords1).reshape(b, h1, w1, dim)
            corr = cost_global if c.only_global else torch.cat(
                [cost_global, cost_forward.to(cost_global.dtype)], dim=-1)
            flow = (coords1 - coords0).permute(0, 3, 1, 2)
            net, up_mask, delta = self.update_block(net, inp, corr.permute(0, 3, 1, 2), flow,
                                                    attention)
            coords1 = coords1 + delta.float().permute(0, 2, 3, 1)
            if not test_mode:
                flows.append(self._upsample(coords1 - coords0, up_mask))
        if test_mode:
            return self._upsample(coords1 - coords0, up_mask)
        return flows

    @staticmethod
    def _upsample(flow, up_mask):
        return upsample_flow_convex(flow.permute(0, 3, 1, 2), up_mask.float()).permute(0, 2, 3, 1)
