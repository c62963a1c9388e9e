"""FlowFormer (things_eval) and the deep ROI step, as the benchmark's reference.

The forward follows the published FlowFormer (Huang et al., ECCV 2022,
arXiv:2203.16194; github.com/drinkingcoder/FlowFormer-Official:
core/FlowFormer/LatentCostFormer/{transformer,encoder,decoder,twins,
attention,gru,gma}.py, core/FlowFormer/encoders.py) and timm's
``twins_svt_large``, written afresh as functions of a state dict in the
published checkpoint's layout (things.pth's keys, ``module.`` prefix
stripped), in plain torch, tokens ``[B, N, C]`` and maps NCHW as published:

- the context and feature encoders: the first two stages of Twins-SVT-large
  (patch-embed 4x, 2 blocks at 128 / 4 heads, patch-embed 2x, 2 blocks at
  256 / 8; LayerNorms at 1e-6 in the blocks); the windowed attention (LSA,
  7x7) zero-pads to whole windows, the global sub-sampled attention (GSA)
  keys come from timm's unpadded ``nn.Conv2d(dim, dim, sr, stride=sr)``
  (floor(side / sr) a side, sr 8 then 4); the PEG, a residual depthwise
  3x3, after each stage's first block;
- the channel convertor and the all-pairs cost volume, not scaled;
- each cost map's patch embedding: zero padding right and bottom to a
  multiple of 8, three stride-2 6x6 convolutions, the sine embedding of the
  patch centres (8i + 4), the coordinate FFN and a LayerNorm;
- 8 latent tokens cross-attending into it, then per layer self-attention
  among them and the vertical attention across source pixels: a 7x7 window
  block and a sub-sampled global block (sr 4, the grid zero-padded to a
  multiple of 4), both conditioned on a projection of the context;
- the decoder: the 9x9 cost window by ``F.grid_sample(align_corners=True)``
  with zero padding, the window's offsets ``stack(meshgrid(dy, dx))`` added
  to (x, y) as published, so x moves along the outer index; the flow token
  and its cross attention into the cost memory; GMA (the attention map over
  every 1/8 position from the context, the aggregation scaled by
  ``gamma``); RAFT's motion encoder, SepConvGRU, flow head and 0.25-scaled
  mask head; convex 8x upsampling.

Departures from the published code:

- the vertical attention pairs context and tokens batch-item-major (token k
  of item b with item b's context); the published
  ``context.repeat(B // context.shape[0], 1, 1, 1)`` tiles the context
  item-minor while the tokens are item-major, which misaligns them for a
  batch of more than one (at B = 1, the published scripts' batch, the two
  agree);
- test mode only: the flow is upsampled once, after the last step (the
  published loop upsamples every step and returns the last, the same flow);
- under ``dt=torch.bfloat16`` the whole model runs under bfloat16 autocast,
  the coordinates and the upsampling in float32;
- float32 arithmetic throughout otherwise: ``raft.fp32`` turns TF32 off
  for both cuDNN and cuBLAS.

:func:`roi_step` adds the ROI step of ff_seg.py around it, as
``raft.roi_step`` does for RAFT: the gate on the MEMSIZE/3 grid, active
only if both of the box's sides reach 64 px; the window; edge padding to a
multiple of 8; the flow, not negated, zero outside the box; the seg head;
the paste.  ``cfg`` is the configuration file's dict
(``benchmark/configs/flowformer.json``).

:func:`synthetic_state` draws weights from a seed in that layout: timm's
initialisation for the Twins trunks, PyTorch's defaults elsewhere, the
LayerNorms' affines away from the identity, and GMA's ``gamma`` away from
its published zero, so that the aggregation is not multiplied away; and
the flow head's last convolution at a tenth of PyTorch's default, so that
32 steps' flow stays of the order of a few pixels (at the default it
drifts by 13-19 px on average over 32 steps at 96x120 on the CPU, every
pixel above the seg head's 1-px threshold).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import raft, segmentation

LN_EPS = 1e-5
TWINS_LN_EPS = 1e-6  # timm's Twins blocks: partial(nn.LayerNorm, eps=1e-6)
# Twins-SVT-large's first two stages: (patch, dim, heads, sr)
TWINS_STAGES = ((4, 128, 4, 8), (2, 256, 8, 4))
WS = 7  # the windowed blocks' window (LSA and the vertical local block)
VERT_SR = 4  # the vertical global block's sub-sampling
HEADS = 8  # the cost encoder's and the decoder's attention heads
RADIUS = 4  # the decoder's 9x9 cost window
CONTEXT_DIM = 256
HIDDEN = 128  # the GRU's hidden state; the context projection's other half is its input
GMA_POS = 160  # gma.py Attention(max_pos_size=160): the unused relative embedding
FLOW_HEAD_SCALE = 0.1  # the synthetic flow head's last convolution, of the default
TWINS_PREFIXES = ("context_encoder.svt", "memory_encoder.feat_encoder.svt")


# ── the state dict ────────────────────────────────────────────────────────


def state_layout(model: dict) -> dict[str, tuple]:
    """Key → shape of a FlowFormer state dict (things.pth's keys) with twins
    encoders, GMA and a 1-head cost volume; the tensors the published model
    registers and never uses (``att.pos_emb``, the Twins' final ``norm``)
    included."""
    if (model["cnet"], model["fnet"], model["cost_heads_num"]) != ("twins", "twins", 1):
        raise ValueError(f"the reference runs twins encoders and one cost head, not {model}")
    if not (model["use_gma"] and model["add_flow_token"]):
        raise ValueError("the reference runs GMA and the flow token")
    out = {}

    def lin(name, cout, cin, bias=True):
        out[f"{name}.weight"] = (cout, cin)
        if bias:
            out[f"{name}.bias"] = (cout,)

    def conv(name, cout, cin, kh, kw=None, bias=True):
        out[f"{name}.weight"] = (cout, cin, kh, kw or kh)
        if bias:
            out[f"{name}.bias"] = (cout,)

    def ln(name, c):
        out[f"{name}.weight"] = out[f"{name}.bias"] = (c,)

    for pre in TWINS_PREFIXES:
        cin = 3
        for i, (patch, dim, _, sr) in enumerate(TWINS_STAGES):
            conv(f"{pre}.patch_embeds.{i}.proj", dim, cin, patch)
            ln(f"{pre}.patch_embeds.{i}.norm", dim)
            for j in (0, 1):
                blk = f"{pre}.blocks.{i}.{j}"
                ln(f"{blk}.norm1", dim)
                if j == 0:
                    lin(f"{blk}.attn.qkv", 3 * dim, dim)
                else:
                    lin(f"{blk}.attn.q", dim, dim)
                    lin(f"{blk}.attn.kv", 2 * dim, dim)
                    conv(f"{blk}.attn.sr", dim, dim, sr)
                    ln(f"{blk}.attn.norm", dim)
                lin(f"{blk}.attn.proj", dim, dim)
                ln(f"{blk}.norm2", dim)
                lin(f"{blk}.mlp.fc1", 4 * dim, dim)
                lin(f"{blk}.mlp.fc2", dim, 4 * dim)
            conv(f"{pre}.pos_block.{i}.proj.0", dim, 1, 3)
            cin = dim
        ln(f"{pre}.norm", 1024)  # timm's final norm of the whole trunk, unused
    latent = model["encoder_latent_dim"]
    conv("memory_encoder.channel_convertor", latent, 256, 1, bias=False)
    cp = "memory_encoder.cost_perceiver_encoder"
    d_in, d = model["cost_latent_input_dim"], model["cost_latent_dim"]
    conv(f"{cp}.patch_embed.proj.0", d_in // 4, 1, 6)
    conv(f"{cp}.patch_embed.proj.2", d_in // 2, d_in // 4, 6)
    conv(f"{cp}.patch_embed.proj.4", d_in, d_in // 2, 6)
    conv(f"{cp}.patch_embed.ffn_with_coord.0", 2 * d_in, 2 * d_in, 1)
    conv(f"{cp}.patch_embed.ffn_with_coord.2", 2 * d_in, 2 * d_in, 1)
    ln(f"{cp}.patch_embed.norm", 2 * d_in)
    out[f"{cp}.latent_tokens"] = (1, model["cost_latent_token_num"], d)

    def attention_layer(name, qdim, tdim, vdim, proj_in):
        ln(f"{name}.norm1", qdim)
        ln(f"{name}.norm2", qdim)
        lin(f"{name}.q", vdim, qdim)
        lin(f"{name}.k", vdim, tdim)
        lin(f"{name}.v", vdim, tdim)
        lin(f"{name}.proj", qdim, proj_in)
        lin(f"{name}.ffn.0", qdim, qdim)
        lin(f"{name}.ffn.3", qdim, qdim)

    attention_layer(f"{cp}.input_layer", d, 2 * d_in, d, d)
    vc = model["vert_c_dim"]
    for i in range(model["encoder_depth"]):
        attention_layer(f"{cp}.encoder_layers.{i}", d, d, d, d)
        for kind in ("local_block", "global_block"):
            blk = f"{cp}.vertical_encoder_layers.{i}.{kind}"
            ln(f"{blk}.norm1", d)
            ln(f"{blk}.norm2", d)
            lin(f"{blk}.attn.context_proj", vc, CONTEXT_DIM)
            lin(f"{blk}.attn.q", d, d + vc)
            lin(f"{blk}.attn.k", d, d + vc if kind == "local_block" else d)
            lin(f"{blk}.attn.v", d, d)
            lin(f"{blk}.attn.proj", d, d)
            if kind == "global_block":
                conv(f"{blk}.attn.sr_key", d, d + vc, VERT_SR)
                conv(f"{blk}.attn.sr_value", d, d, VERT_SR)
                ln(f"{blk}.attn.norm", d)
            lin(f"{blk}.mlp.fc1", 4 * d, d)
            lin(f"{blk}.mlp.fc2", d, 4 * d)
    md = "memory_decoder"
    q = model["query_latent_dim"]
    conv(f"{md}.flow_token_encoder.0", q, (2 * RADIUS + 1) ** 2, 1)
    conv(f"{md}.flow_token_encoder.2", q, q, 1)
    conv(f"{md}.proj", CONTEXT_DIM, CONTEXT_DIM, 1)
    attention_layer(f"{md}.decoder_layer.cross_attend", q, d, q, 2 * q)
    conv(f"{md}.att.to_qk", 2 * HIDDEN, HIDDEN, 1, bias=False)
    out[f"{md}.att.pos_emb.rel_height.weight"] = (2 * GMA_POS - 1, HIDDEN)
    out[f"{md}.att.pos_emb.rel_width.weight"] = (2 * GMA_POS - 1, HIDDEN)
    u = f"{md}.update_block"
    cor = q if model["only_global"] else q + (2 * RADIUS + 1) ** 2
    conv(f"{u}.encoder.convc1", 256, cor, 1)
    conv(f"{u}.encoder.convc2", 192, 256, 3)
    conv(f"{u}.encoder.convf1", 128, 2, 7)
    conv(f"{u}.encoder.convf2", 64, 128, 3)
    conv(f"{u}.encoder.conv", 128 - 2, 64 + 192, 3)
    for g in "zrq":
        conv(f"{u}.gru.conv{g}1", HIDDEN, 4 * HIDDEN, 1, 5)
        conv(f"{u}.gru.conv{g}2", HIDDEN, 4 * HIDDEN, 5, 1)
    conv(f"{u}.flow_head.conv1", 256, HIDDEN, 3)
    conv(f"{u}.flow_head.conv2", 2, 256, 3)
    conv(f"{u}.mask.0", 256, HIDDEN, 3)
    conv(f"{u}.mask.2", 64 * 9, 256, 1)
    conv(f"{u}.aggregator.to_v", HIDDEN, HIDDEN, 1, bias=False)
    out[f"{u}.aggregator.gamma"] = (1,)
    return out


def synthetic_state(seed: int, model: dict) -> dict[str, torch.Tensor]:
    """Seeded float32 weights in :func:`state_layout`'s layout, on the CPU:
    the Twins trunks as timm initialises them (Linear weights normal with
    std 0.02, convolutions normal with std √(2 / fan-out)), their biases
    drawn small; every other Linear and convolution PyTorch's default
    uniform(±1/√fan-in); LayerNorm weights in [0.7, 1.3] and biases normal
    (0.1); the latent tokens and the unused embeddings standard normal; GMA's
    ``gamma`` in [0.5, 1]; the flow head's last convolution at a tenth of
    the default (:data:`FLOW_HEAD_SCALE`)."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, 0xF10F])
    layout = state_layout(model)
    out = {}
    for key, shape in layout.items():
        name, leaf = key.rsplit(".", 1)
        twins = key.startswith(TWINS_PREFIXES)
        w = layout.get(f"{name}.weight")
        if key.endswith(("latent_tokens", "rel_height.weight", "rel_width.weight")):
            v = rng.standard_normal(shape)
        elif leaf == "gamma":
            v = rng.uniform(0.5, 1.0, shape)
        elif len(w) == 1:  # a LayerNorm
            v = rng.uniform(0.7, 1.3, shape) if leaf == "weight" else rng.normal(0.0, 0.1, shape)
        elif twins and leaf == "bias":
            v = rng.normal(0.0, 0.02, shape)
        elif twins and len(w) == 2:
            v = np.clip(rng.normal(0.0, 0.02, shape), -0.04, 0.04)  # timm's trunc_normal_
        elif twins:
            groups = w[0] if w[1] == 1 else 1
            v = rng.standard_normal(shape) * np.sqrt(2.0 / (w[0] * w[2] * w[3] / groups))
        else:
            fan_in = int(np.prod(w[1:]))
            v = rng.uniform(-1.0, 1.0, shape) / np.sqrt(fan_in)
        if name == "memory_decoder.update_block.flow_head.conv2":
            v = v * FLOW_HEAD_SCALE
        out[key] = torch.from_numpy(np.asarray(v, dtype=np.float32))
    return out


# ── pieces ────────────────────────────────────────────────────────────────


def _lin(st, name, x):
    return F.linear(x, st[f"{name}.weight"], st.get(f"{name}.bias"))


def _ln(st, name, x, eps=LN_EPS):
    return F.layer_norm(x, x.shape[-1:], st[f"{name}.weight"], st[f"{name}.bias"], eps)


def _conv(st, name, x, stride=1, padding=0, groups=1):
    return F.conv2d(x, st[f"{name}.weight"], st.get(f"{name}.bias"), stride=stride,
                    padding=padding, groups=groups)


def _mlp(st, name, x):
    return _lin(st, f"{name}.fc2", F.gelu(_lin(st, f"{name}.fc1", x)))


def _ffn(st, name, x):
    return _lin(st, f"{name}.3", F.gelu(_lin(st, f"{name}.0", x)))


def _heads(x, heads):
    """``[B, N, heads·d]`` → ``[B, heads, N, d]``."""
    b, n, c = x.shape
    return x.reshape(b, n, heads, c // heads).permute(0, 2, 1, 3)


def _merge(x):
    """``[B, heads, N, d]`` → ``[B, N, heads·d]``."""
    b, h, n, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, n, h * d)


def _attend(q, k, v, scale):
    return torch.softmax((q @ k.transpose(-2, -1)) * scale, dim=-1) @ v


def coords_grid(b: int, h: int, w: int, dev) -> torch.Tensor:
    """``[B, 2, H, W]`` pixel coordinates, (x, y)."""
    ys, xs = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev),
                            indexing="ij")
    return torch.stack([xs, ys], dim=0).float()[None].repeat(b, 1, 1, 1)


def pos_embed(coords: torch.Tensor, dim: int) -> torch.Tensor:
    """LinearPositionEmbeddingSine (attention.py): ``[..., 2]`` (x, y) →
    ``[..., dim]``, sines and cosines of 3.14·coord·k/200, k < dim/4."""
    freq = torch.linspace(0, dim // 4 - 1, dim // 4, device=coords.device)
    x, y = (3.14 * c * freq * (1 / 200) for c in (coords[..., -2:-1], coords[..., -1:]))
    return torch.cat([torch.sin(x), torch.cos(x), torch.sin(y), torch.cos(y)], dim=-1)


def _grid_enc(b: int, h: int, w: int, dim: int, dev, scale: float = 1.0) -> torch.Tensor:
    """The sine embedding of an ``h`` × ``w`` grid's coordinates × ``scale``,
    ``[B, h·w, dim]``."""
    coords = coords_grid(b, h, w, dev).view(b, 2, -1).permute(0, 2, 1) * scale
    return pos_embed(coords, dim)


# ── Twins-SVT (timm) ──────────────────────────────────────────────────────


def lsa(st, pre, x, size, heads, ws=WS):
    """LocallyGroupedAttn: attention inside ws×ws windows of the grid
    zero-padded right and bottom to whole windows."""
    b, n, c = x.shape
    h, w = size
    x = F.pad(x.view(b, h, w, c), (0, 0, 0, (ws - w % ws) % ws, 0, (ws - h % ws) % ws))
    hp, wp = x.shape[1:3]
    nh, nw = hp // ws, wp // ws
    x = x.reshape(b, nh, ws, nw, ws, c).transpose(2, 3)
    qkv = _lin(st, f"{pre}.qkv", x).reshape(b, nh * nw, ws * ws, 3, heads, c // heads)
    q, k, v = qkv.permute(3, 0, 1, 4, 2, 5)
    out = _attend(q, k, v, (c // heads) ** -0.5).transpose(2, 3)
    out = out.reshape(b, nh, nw, ws, ws, c).transpose(2, 3).reshape(b, hp, wp, c)
    return _lin(st, f"{pre}.proj", out[:, :h, :w].reshape(b, n, c))


def gsa(st, pre, x, size, heads, sr):
    """GlobalSubSampleAttn: every query attends to the keys of the grid
    sub-sampled by the unpadded ``sr`` convolution."""
    b, n, c = x.shape
    q = _heads(_lin(st, f"{pre}.q", x), heads)
    kv = _conv(st, f"{pre}.sr", x.permute(0, 2, 1).reshape(b, c, *size), stride=sr)
    kv = _ln(st, f"{pre}.norm", kv.reshape(b, c, -1).permute(0, 2, 1))
    k, v = _lin(st, f"{pre}.kv", kv).reshape(b, -1, 2, heads, c // heads).permute(2, 0, 3, 1, 4)
    return _lin(st, f"{pre}.proj", _merge(_attend(q, k, v, (c // heads) ** -0.5)))


def twins(st, pre: str, x: torch.Tensor) -> torch.Tensor:
    """encoders.py twins_svt_large, its first two stages: ``[B, 3, H, W]``
    → ``[B, 256, H/8, W/8]``."""
    b = x.shape[0]
    for i, (patch, dim, heads, sr) in enumerate(TWINS_STAGES):
        x = _conv(st, f"{pre}.patch_embeds.{i}.proj", x, stride=patch)
        size = x.shape[-2:]
        x = _ln(st, f"{pre}.patch_embeds.{i}.norm", x.flatten(2).transpose(1, 2))
        for j in (0, 1):
            blk = f"{pre}.blocks.{i}.{j}"
            y = _ln(st, f"{blk}.norm1", x, TWINS_LN_EPS)
            x = x + (lsa(st, f"{blk}.attn", y, size, heads) if j == 0
                     else gsa(st, f"{blk}.attn", y, size, heads, sr))
            x = x + _mlp(st, f"{blk}.mlp", _ln(st, f"{blk}.norm2", x, TWINS_LN_EPS))
            if j == 0:  # the PEG
                feat = x.transpose(1, 2).reshape(b, dim, *size)
                feat = _conv(st, f"{pre}.pos_block.{i}.proj.0", feat, padding=1, groups=dim) + feat
                x = feat.flatten(2).transpose(1, 2)
        x = x.transpose(1, 2).reshape(b, dim, *size)
    return x


# ── the memory encoder ────────────────────────────────────────────────────


def cost_maps(f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
    """MemoryEncoder.corr, one head, as the cost encoder takes it: ``[B, C,
    H, W]`` features → ``[B·H·W, 1, H, W]``, not scaled."""
    b, c, h, w = f1.shape
    corr = f1.reshape(b, c, h * w).transpose(1, 2) @ f2.reshape(b, c, h * w)
    return corr.reshape(b * h * w, 1, h, w)


def patch_embed(st, pre, cost: torch.Tensor, dim: int) -> torch.Tensor:
    """encoder.py PatchEmbed (patch 8): ``[N, 1, H2, W2]`` → ``[N, H3·W3,
    2·dim]``."""
    n, _, h2, w2 = cost.shape
    x = F.pad(cost, (0, (8 - w2 % 8) % 8, 0, (8 - h2 % 8) % 8))
    x = F.relu(_conv(st, f"{pre}.proj.0", x, 2, 2))
    x = F.relu(_conv(st, f"{pre}.proj.2", x, 2, 2))
    x = _conv(st, f"{pre}.proj.4", x, 2, 2)
    h3, w3 = x.shape[-2:]
    centre = coords_grid(n, h3, w3, x.device) * 8 + 8 / 2
    enc = pos_embed(centre.view(n, 2, -1).permute(0, 2, 1), dim)
    x = torch.cat([x, enc.permute(0, 2, 1).reshape(n, dim, h3, w3)], dim=1)
    x = _conv(st, f"{pre}.ffn_with_coord.2", F.relu(_conv(st, f"{pre}.ffn_with_coord.0", x)))
    return _ln(st, f"{pre}.norm", x.flatten(2).transpose(1, 2))


def mha(q, k, v, dim: int, heads: int = HEADS):
    """attention.py MultiHeadAttention, scale (dim / heads)^-0.5."""
    return _merge(_attend(_heads(q, heads), _heads(k, heads), _heads(v, heads),
                          (dim / heads) ** -0.5))


def cross_layer(st, pre, query, tgt, dim):
    """encoder.py CrossAttentionLayer: ``query`` attends into ``tgt``."""
    x = _ln(st, f"{pre}.norm1", query)
    x = query + _lin(st, f"{pre}.proj", mha(_lin(st, f"{pre}.q", x), _lin(st, f"{pre}.k", tgt),
                                             _lin(st, f"{pre}.v", tgt), dim))
    return x + _ffn(st, f"{pre}.ffn", _ln(st, f"{pre}.norm2", x))


def self_layer(st, pre, x, dim):
    """encoder.py SelfAttentionLayer."""
    y = _ln(st, f"{pre}.norm1", x)
    x = x + _lin(st, f"{pre}.proj", mha(_lin(st, f"{pre}.q", y), _lin(st, f"{pre}.k", y),
                                         _lin(st, f"{pre}.v", y), dim))
    return x + _ffn(st, f"{pre}.ffn", _ln(st, f"{pre}.norm2", x))


def _context(st, pre, context, bk, size):
    """The context's projection for each of ``bk`` token maps,
    ``[BK, H, W, vert_c_dim]``, item-major (see the module's docstring)."""
    ctx = context.repeat_interleave(bk // context.shape[0], dim=0)
    ctx = _lin(st, f"{pre}.context_proj", ctx.flatten(2).transpose(1, 2))
    return ctx.view(bk, *size, -1)


def vertical_local(st, pre, x, size, context, heads=HEADS, ws=WS):
    """twins.py LocallyGroupedAttnRPEContext: windowed attention whose
    queries and keys see the context and the sine embedding of the
    position inside the window."""
    b, n, c = x.shape
    h, w = size
    x_qk = torch.cat([x.view(b, h, w, c), _context(st, pre, context, b, size)], dim=-1)
    cq = x_qk.shape[-1]
    pad = (0, 0, 0, (ws - w % ws) % ws, 0, (ws - h % ws) % ws)
    xv, x_qk = F.pad(x.view(b, h, w, c), pad), F.pad(x_qk, pad)
    hp, wp = xv.shape[1:3]
    nh, nw = hp // ws, wp // ws
    xv = xv.reshape(b, nh, ws, nw, ws, c).transpose(2, 3)
    x_qk = x_qk.reshape(b, nh, ws, nw, ws, cq).transpose(2, 3)
    x_qk = x_qk + _grid_enc(b, ws, ws, cq, x.device).view(b, ws, ws, cq)[:, None, None]

    def split(t):
        return t.reshape(b, nh * nw, ws * ws, heads, c // heads).permute(0, 1, 3, 2, 4)

    out = _attend(split(_lin(st, f"{pre}.q", x_qk)), split(_lin(st, f"{pre}.k", x_qk)),
                  split(_lin(st, f"{pre}.v", xv)), (c // heads) ** -0.5).transpose(2, 3)
    out = out.reshape(b, nh, nw, ws, ws, c).transpose(2, 3).reshape(b, hp, wp, c)
    return _lin(st, f"{pre}.proj", out[:, :h, :w].reshape(b, n, c))


def vertical_global(st, pre, x, size, context, heads=HEADS, sr=VERT_SR):
    """twins.py GlobalSubSampleAttnRPEContext: queries see the context and
    their padded-grid position; keys (from the context-joined map) and
    values come from sr×sr convolutions of the grid zero-padded to a
    multiple of sr, one LayerNorm for both, the keys at their sub-sampled
    positions × sr."""
    b, n, c = x.shape
    h, w = size
    x_qk = torch.cat([x.view(b, h, w, c), _context(st, pre, context, b, size)], dim=-1)
    cq = x_qk.shape[-1]
    pad = (0, 0, 0, (sr - w % sr) % sr, 0, (sr - h % sr) % sr)
    xv, x_qk = F.pad(x.view(b, h, w, c), pad), F.pad(x_qk, pad)
    hp, wp = xv.shape[1:3]
    xv, x_qk = xv.reshape(b, -1, c), x_qk.reshape(b, -1, cq)
    q = _heads(_lin(st, f"{pre}.q", x_qk + _grid_enc(b, hp, wp, cq, x.device)), heads)
    v = _conv(st, f"{pre}.sr_value", xv.permute(0, 2, 1).reshape(b, c, hp, wp), stride=sr)
    k = _conv(st, f"{pre}.sr_key", x_qk.permute(0, 2, 1).reshape(b, cq, hp, wp), stride=sr)
    v = _ln(st, f"{pre}.norm", v.reshape(b, c, -1).permute(0, 2, 1))
    k = _ln(st, f"{pre}.norm", k.reshape(b, c, -1).permute(0, 2, 1))
    k = _heads(_lin(st, f"{pre}.k", k + _grid_enc(b, hp // sr, wp // sr, c, x.device, sr)), heads)
    v = _heads(_lin(st, f"{pre}.v", v), heads)
    out = _merge(_attend(q, k, v, (c // heads) ** -0.5)).reshape(b, hp, wp, c)
    return _lin(st, f"{pre}.proj", out[:, :h, :w].reshape(b, n, c))


def vertical_layer(st, pre, x, size, context):
    """encoder.py VerticalSelfAttentionLayer: the local block, then the
    global one, each a Twins Block (LayerNorms at PyTorch's 1e-5)."""
    for kind, attn in (("local_block", vertical_local), ("global_block", vertical_global)):
        blk = f"{pre}.{kind}"
        x = x + attn(st, f"{blk}.attn", _ln(st, f"{blk}.norm1", x), size, context)
        x = x + _mlp(st, f"{blk}.mlp", _ln(st, f"{blk}.norm2", x))
    return x


def cost_memory(st, model: dict, maps: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
    """CostPerceiverEncoder: cost maps ``[B·H1·W1, 1, H2, W2]`` and the
    context ``[B, 256, H1, W1]`` → the memory ``[B·H1·W1, K, D]``."""
    cp = "memory_encoder.cost_perceiver_encoder"
    b, _, h1, w1 = context.shape
    k, d = model["cost_latent_token_num"], model["cost_latent_dim"]
    x = patch_embed(st, f"{cp}.patch_embed", maps, model["cost_latent_input_dim"])
    x = cross_layer(st, f"{cp}.input_layer", st[f"{cp}.latent_tokens"], x, d)
    short_cut = x
    for i in range(model["encoder_depth"]):
        x = self_layer(st, f"{cp}.encoder_layers.{i}", x, d)
        x = x.view(b, h1 * w1, k, d).permute(0, 2, 1, 3).reshape(b * k, h1 * w1, d)
        x = vertical_layer(st, f"{cp}.vertical_encoder_layers.{i}", x, (h1, w1), context)
        x = x.view(b, k, h1 * w1, d).permute(0, 2, 1, 3).reshape(b * h1 * w1, k, d)
    return x + short_cut if model["cost_encoder_res"] else x


# ── the memory decoder ────────────────────────────────────────────────────


def flow_token(maps: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """MemoryDecoder.encode_flow_token with ``bilinear_sampler``: the 9×9
    window of each cost map at ``coords`` ``[B, 2, H1, W1]`` → ``[B, 81, H1,
    W1]``."""
    b, _, h1, w1 = coords.shape
    r = RADIUS
    dx = torch.linspace(-r, r, 2 * r + 1, device=coords.device)
    dy = torch.linspace(-r, r, 2 * r + 1, device=coords.device)
    delta = torch.stack(torch.meshgrid(dy, dx, indexing="ij"), dim=-1).view(1, 2 * r + 1,
                                                                            2 * r + 1, 2)
    pts = coords.permute(0, 2, 3, 1).reshape(b * h1 * w1, 1, 1, 2) + delta
    hm, wm = maps.shape[-2:]
    xg, yg = pts.split([1, 1], dim=-1)
    grid = torch.cat([2 * xg / (wm - 1) - 1, 2 * yg / (hm - 1) - 1], dim=-1)
    corr = F.grid_sample(maps, grid.to(maps.dtype), align_corners=True)
    return corr.view(b, h1, w1, -1).permute(0, 3, 1, 2)


def decoder_cross(st, pre, query, key, value, coords, dim):
    """decoder.py CrossAttentionLayer with the flow token: the query plus
    the sine embedding of its coordinates attends into the memory's
    projections; the projection sees the attended value and the query."""
    b, _, h1, w1 = coords.shape
    enc = pos_embed(coords.reshape(b, 2, -1).permute(0, 2, 1).reshape(b * h1 * w1, 1, 2), dim)
    x = _ln(st, f"{pre}.norm1", query)
    out = mha(_lin(st, f"{pre}.q", x + enc), key, value, dim)
    x = query + _lin(st, f"{pre}.proj", torch.cat([out, query], dim=2))
    return x + _ffn(st, f"{pre}.ffn", _ln(st, f"{pre}.norm2", x))


def gma_attention(st, pre, inp):
    """gma.py Attention, content only, 1 head of 128: ``[B, 128, H, W]`` →
    ``[B, 1, H·W, H·W]``."""
    q, k = _conv(st, f"{pre}.to_qk", inp).chunk(2, dim=1)
    q = q.flatten(2).transpose(1, 2)[:, None] * HIDDEN ** -0.5
    k = k.flatten(2).transpose(1, 2)[:, None]
    return torch.softmax(q @ k.transpose(-2, -1), dim=-1)


def update(st, net, inp, corr, flow, attention):
    """gru.py GMAUpdateBlock → (net, mask, delta_flow)."""
    u = "memory_decoder.update_block"
    cor = F.relu(_conv(st, f"{u}.encoder.convc1", corr))
    cor = F.relu(_conv(st, f"{u}.encoder.convc2", cor, padding=1))
    flo = F.relu(_conv(st, f"{u}.encoder.convf1", flow, padding=3))
    flo = F.relu(_conv(st, f"{u}.encoder.convf2", flo, padding=1))
    out = F.relu(_conv(st, f"{u}.encoder.conv", torch.cat([cor, flo], dim=1), padding=1))
    motion = torch.cat([out, flow], dim=1)
    b, c, h, w = motion.shape
    v = _conv(st, f"{u}.aggregator.to_v", motion).flatten(2).transpose(1, 2)[:, None]
    agg = (attention @ v)[:, 0].transpose(1, 2).reshape(b, c, h, w)
    x = torch.cat([inp, motion, motion + st[f"{u}.aggregator.gamma"] * agg], dim=1)
    for k, pad in (("1", (0, 2)), ("2", (2, 0))):
        hx = torch.cat([net, x], dim=1)
        z = torch.sigmoid(_conv(st, f"{u}.gru.convz{k}", hx, padding=pad))
        r = torch.sigmoid(_conv(st, f"{u}.gru.convr{k}", hx, padding=pad))
        q = torch.tanh(_conv(st, f"{u}.gru.convq{k}", torch.cat([r * net, x], dim=1), padding=pad))
        net = (1 - z) * net + z * q
    delta = _conv(st, f"{u}.flow_head.conv2",
                  F.relu(_conv(st, f"{u}.flow_head.conv1", net, padding=1)), padding=1)
    mask = 0.25 * _conv(st, f"{u}.mask.2", F.relu(_conv(st, f"{u}.mask.0", net, padding=1)))
    return net, mask, delta


# ── the forward ───────────────────────────────────────────────────────────


def flowformer_flow(st: dict, image1: torch.Tensor, image2: torch.Tensor, model: dict,
                    dt=torch.float32) -> torch.Tensor:
    """The final flow ``[B, H, W, 2]`` of ``model["decoder_depth"]`` steps
    on ``[B, H, W, 3]`` RGB frames (H, W multiples of 8)."""
    dev = image1.device
    md = "memory_decoder"
    with torch.no_grad(), raft._mixed(dev, dt):
        i1 = 2 * (image1.permute(0, 3, 1, 2).float() / 255.0) - 1.0
        i2 = 2 * (image2.permute(0, 3, 1, 2).float() / 255.0) - 1.0
        b = i1.shape[0]
        context = twins(st, "context_encoder.svt", i1)
        feats = twins(st, "memory_encoder.feat_encoder.svt", torch.cat([i1, i2], dim=0))
        feats = _conv(st, "memory_encoder.channel_convertor", feats)
        maps = cost_maps(feats[:b], feats[b:])
        memory = cost_memory(st, model, maps, context)
        cross = f"{md}.decoder_layer.cross_attend"
        key, value = _lin(st, f"{cross}.k", memory), _lin(st, f"{cross}.v", memory)
        ctx = _conv(st, f"{md}.proj", context)
        net, inp = torch.tanh(ctx[:, :HIDDEN]), torch.relu(ctx[:, HIDDEN:])
        attention = gma_attention(st, f"{md}.att", inp)
        _, _, h1, w1 = ctx.shape
        coords0 = coords_grid(b, h1, w1, dev)
        coords1 = coords0.clone()
        dim = model["query_latent_dim"]
        mask = None
        for _ in range(model["decoder_depth"]):
            cost_forward = flow_token(maps, coords1)
            query = _conv(st, f"{md}.flow_token_encoder.2",
                          F.gelu(_conv(st, f"{md}.flow_token_encoder.0", cost_forward)))
            query = query.permute(0, 2, 3, 1).reshape(b * h1 * w1, 1, dim)
            cost_global = decoder_cross(st, cross, query, key, value, coords1, dim)
            cost_global = cost_global.view(b, h1, w1, dim).permute(0, 3, 1, 2)
            corr = (cost_global if model["only_global"]
                    else torch.cat([cost_global, cost_forward.to(cost_global.dtype)], dim=1))
            net, mask, delta = update(st, net, inp, corr, coords1 - coords0, attention)
            coords1 = coords1 + delta.float()
    with torch.no_grad():
        return raft.upsample_flow(coords1 - coords0, mask.float()).permute(0, 2, 3, 1)


# ── the ROI step ──────────────────────────────────────────────────────────


def roi_step(mem, prev, nxt, cfg: dict, state: dict, dt=torch.float32) -> dict:
    """The deep ROI step on a batch, as ``raft.roi_step`` with FlowFormer
    for RAFT: ``mem`` ``[B, gh, gw]`` uint8 on the MEMSIZE/3 grid,
    ``prev``/``nxt`` ``[B, H, W, 3]`` uint8 → ``flow`` [B, H, W, 2] float32
    (zero outside the box), ``mask`` [B, H, W] uint8 {0, 255}, ``box`` [B,
    4] int32 and ``any_active`` [B].  ``state`` is on ``prev``'s device;
    ``dt`` the model's arithmetic."""
    h, w = prev.shape[1:3]
    deep = dict(cfg, image_h=h, image_w=w,
                roi=dict(cfg["roi"], memsize=max(cfg["roi"]["memsize"] // 3, 1)))
    box, any_active = segmentation.gate(mem, deep)
    active = (any_active & ((box[:, 2] - box[:, 0]) >= raft.MIN_REGION_PX)
              & ((box[:, 3] - box[:, 1]) >= raft.MIN_REGION_PX))
    wh, ww = cfg["window_h"] or h, cfg["window_w"] or w
    oy = box[:, 1].long().clamp(0, h - wh)
    ox = box[:, 0].long().clamp(0, w - ww)
    dev = prev.device
    b = mem.shape[0]
    ys = oy[:, None, None] + torch.arange(wh, device=dev)[None, :, None]
    xs = ox[:, None, None] + torch.arange(ww, device=dev)[None, None, :]
    bi = torch.arange(b, device=dev)[:, None, None]
    p1, top, left = raft._pad8(prev[bi, ys, xs])
    p2, _, _ = raft._pad8(nxt[bi, ys, xs])
    with raft.fp32():
        flow = flowformer_flow(state, p1, p2, cfg["model"], dt)[:, top: top + wh, left: left + ww]
    bx = box.long()
    inbox = ((ys >= bx[:, 1, None, None]) & (ys < bx[:, 3, None, None])
             & (xs >= bx[:, 0, None, None]) & (xs < bx[:, 2, None, None])
             & active[:, None, None])
    flow = torch.where(inbox[..., None], flow, 0.0)
    m = segmentation.head(flow[..., 0] * flow[..., 0] + flow[..., 1] * flow[..., 1], inbox, cfg)
    mask = torch.zeros((b, h, w), dtype=torch.uint8, device=dev)
    mask[bi, ys, xs] = torch.where(inbox, m.to(torch.uint8) * 255, 0).to(torch.uint8)
    fl = torch.zeros((b, h, w, 2), dtype=torch.float32, device=dev)
    fl[bi, ys, xs] = flow
    return {"mask": mask, "flow": fl, "box": box, "any_active": active}
