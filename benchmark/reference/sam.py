"""Segment Anything (SAM) and the ground-truth mask step, as the benchmark's
reference.

The forward follows the published Segment Anything (Kirillov et al., ICCV
2023, arXiv:2304.02643; github.com/facebookresearch/segment-anything:
segment_anything/modeling/{image_encoder,prompt_encoder,transformer,
mask_decoder,sam,common}.py, utils/transforms.py, predictor.py), written
afresh as functions of a state dict in the published checkpoint's layout
(``sam_vit_h_4b8939.pth``'s keys), in plain torch, tokens ``[B, H, W, C]``
in the encoder and maps NCHW as published:

- the image encoder (ViTDet): a 16x16 patch embedding, the absolute
  position embedding, pre-LN blocks (LayerNorm eps 1e-6, exact GELU, MLP
  ratio 4); a windowed block zero-pads the normalised tokens to whole
  windows and folds them into the batch (``window_partition``), a global
  block attends over the whole grid; every block adds the decomposed
  relative-position bias (q·R_h and q·R_w, q unscaled) to the scaled
  logits; the neck, a 1x1 and a 3x3 convolution without bias, each followed
  by the channel LayerNorm2d (its own mean, variance and square root);
- the prompt encoder for boxes: each corner (+0.5, over the input size)
  through the random-Fourier encoding, plus the two corner embeddings; the
  ``no_mask_embed`` as the dense embedding; the dense positional encoding of
  the embedding grid from ``cumsum`` of ones;
- the mask decoder: the IoU and mask tokens before the box's, the image
  embedding repeated once a box, the two-way transformer (self attention,
  token-to-image and image-to-token attention at half width, a ReLU MLP,
  LayerNorms eps 1e-5), the final token-to-image attention, two transposed
  convolutions, the hypernetwork MLPs and the IoU head;
  ``multimask_output=False``, so the first mask and its score, as LangSAM's
  ``predict_sam`` (lang_sam.py:105-115) asks;
- ``postprocess_masks``: bilinear ``F.interpolate`` (align_corners=False)
  to the square, the crop, bilinear to the frame, the threshold at 0.

:func:`sam_gt` is the published ``Sam.forward`` on a batch of records: the
frames preprocessed and encoded together, then each frame's boxes decoded
against its own embedding and post-processed, frame by frame; the frame's
mask is the OR of its boxes' masks (LangSAM's ``running_test.py``).

Departures from the published code:

- the longest side is resized with ``cv2.resize(INTER_LINEAR)``'s uint8
  arithmetic (:func:`resize_linear_u8`, written here from OpenCV's
  ``resize.cpp``: 11-bit fixed-point weights, the rows blended along x, the
  vectorised row blend), where the published ``ResizeLongestSide`` calls
  PIL's ``resize``; the port and the JAX package resize as OpenCV does;
- the boxes are scaled to the resized frame in float32
  (``apply_boxes_torch``, LangSAM's path), not float64 (``apply_boxes``);
- under ``dt=torch.bfloat16`` the encoder and the decoder run under
  bfloat16 autocast, the resizes, the normalisation and the threshold in
  float32; otherwise float32 throughout (``raft.fp32`` turns TF32 off in
  cuDNN and cuBLAS).

:func:`synthetic_state` draws weights from a seed in that layout on a
device: PyTorch's default initialisation for every Linear and convolution
(uniform ±1/√fan-in, weights and biases), LayerNorms at the identity, the
embeddings and the Fourier matrix standard normal, as published; and three
kinds away from it, as a trained checkpoint has them: the relative-position
tables (zero at initialisation, so the bias would vanish) and the absolute
position embedding (zero too), normal with std :data:`REL_POS_STD` and
:data:`POS_EMBED_STD` (ViTDet's ``trunc_normal_(std=0.02)`` for both); and
the mask head's outputs: the last transposed convolution and each
hypernetwork's last Linear ×:data:`HEAD_SCALE`, and that Linear's weights
and bias centred over its outputs.  A mask logit is the hypernetwork's
vector dotted with the upscaled embedding's channels, which the GELU keeps
mostly positive, so a vector whose entries sum far from 0 makes the mask
all or nothing: uncentred, one seed in ten covered every pixel of every
frame at a small cut on the CPU, and 0.83-0.99 of the frames on the card;
centred, 0.45-0.84 on the same ten seeds.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.raft import _mixed, fp32

PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)
ENC_EPS = 1e-6  # build_sam.py: partial(torch.nn.LayerNorm, eps=1e-6); LayerNorm2d's default
DEC_EPS = 1e-5  # transformer.py: nn.LayerNorm's default
MASK_THRESHOLD = 0.0
HEAD_SCALE = 20.0  # the mask head's outputs, of PyTorch's default
REL_POS_STD = 0.1
POS_EMBED_STD = 0.02
COEF_BITS = 11  # OpenCV's INTER_RESIZE_COEF_BITS
SALT = 0x5A4D


# ── the state dict ────────────────────────────────────────────────────────


def state_layout(model: dict) -> dict[str, tuple]:
    """Key → (shape, kind, fan-in) of a SAM state dict (the published
    checkpoint's keys).  Kinds: 'linear' and 'conv' (weights and biases),
    'ln', 'embed', 'rel_pos', 'pos_embed'."""
    d, depth = model["encoder_embed_dim"], model["encoder_depth"]
    hd = d // model["encoder_num_heads"]
    p, s = model["vit_patch_size"], model["image_size"] // model["vit_patch_size"]
    pd, mc = model["prompt_embed_dim"], model["mask_in_chans"]
    nm = model["num_multimask_outputs"] + 1
    mlp = int(d * model["mlp_ratio"])
    out = {}

    def lin(name, cout, cin):
        out[f"{name}.weight"] = ((cout, cin), "linear", cin)
        out[f"{name}.bias"] = ((cout,), "linear", cin)

    def conv(name, cout, cin, k, bias=True, transposed=False):
        shape = (cin, cout, k, k) if transposed else (cout, cin, k, k)
        fan = shape[1] * k * k  # PyTorch's fan-in: dim 1 of the weight
        out[f"{name}.weight"] = (shape, "conv", fan)
        if bias:
            out[f"{name}.bias"] = ((cout,), "conv", fan)

    def ln(name, c):
        out[f"{name}.weight"] = ((c,), "ln", 0)
        out[f"{name}.bias"] = ((c,), "ln", 0)

    def embed(name, n, c):
        out[name] = ((n, c), "embed", 0)

    enc = "image_encoder"
    out[f"{enc}.pos_embed"] = ((1, s, s, d), "pos_embed", 0)
    conv(f"{enc}.patch_embed.proj", d, 3, p)
    for i in range(depth):
        b = f"{enc}.blocks.{i}"
        size = s if i in model["encoder_global_attn_indexes"] else model["window_size"]
        ln(f"{b}.norm1", d)
        out[f"{b}.attn.rel_pos_h"] = ((2 * size - 1, hd), "rel_pos", 0)
        out[f"{b}.attn.rel_pos_w"] = ((2 * size - 1, hd), "rel_pos", 0)
        lin(f"{b}.attn.qkv", 3 * d, d)
        lin(f"{b}.attn.proj", d, d)
        ln(f"{b}.norm2", d)
        lin(f"{b}.mlp.lin1", mlp, d)
        lin(f"{b}.mlp.lin2", d, mlp)
    conv(f"{enc}.neck.0", pd, d, 1, bias=False)
    ln(f"{enc}.neck.1", pd)
    conv(f"{enc}.neck.2", pd, pd, 3, bias=False)
    ln(f"{enc}.neck.3", pd)

    pe = "prompt_encoder"
    out[f"{pe}.pe_layer.positional_encoding_gaussian_matrix"] = ((2, pd // 2), "embed", 0)
    for i in range(4):
        embed(f"{pe}.point_embeddings.{i}.weight", 1, pd)
    embed(f"{pe}.not_a_point_embed.weight", 1, pd)
    conv(f"{pe}.mask_downscaling.0", mc // 4, 1, 2)
    ln(f"{pe}.mask_downscaling.1", mc // 4)
    conv(f"{pe}.mask_downscaling.3", mc, mc // 4, 2)
    ln(f"{pe}.mask_downscaling.4", mc)
    conv(f"{pe}.mask_downscaling.6", pd, mc, 1)
    embed(f"{pe}.no_mask_embed.weight", 1, pd)

    md = "mask_decoder"
    for i in range(model["decoder_depth"]):
        lay = f"{md}.transformer.layers.{i}"
        for name, ds in (("self_attn", 1), ("cross_attn_token_to_image", 2),
                         ("cross_attn_image_to_token", 2)):
            for proj in ("q_proj", "k_proj", "v_proj"):
                lin(f"{lay}.{name}.{proj}", pd // ds, pd)
            lin(f"{lay}.{name}.out_proj", pd, pd // ds)
        ln(f"{lay}.norm1", pd)
        ln(f"{lay}.norm2", pd)
        lin(f"{lay}.mlp.lin1", model["decoder_mlp_dim"], pd)
        lin(f"{lay}.mlp.lin2", pd, model["decoder_mlp_dim"])
        ln(f"{lay}.norm3", pd)
        ln(f"{lay}.norm4", pd)
    for proj in ("q_proj", "k_proj", "v_proj"):
        lin(f"{md}.transformer.final_attn_token_to_image.{proj}", pd // 2, pd)
    lin(f"{md}.transformer.final_attn_token_to_image.out_proj", pd, pd // 2)
    ln(f"{md}.transformer.norm_final_attn", pd)
    embed(f"{md}.iou_token.weight", 1, pd)
    embed(f"{md}.mask_tokens.weight", nm, pd)
    conv(f"{md}.output_upscaling.0", pd // 4, pd, 2, transposed=True)
    ln(f"{md}.output_upscaling.1", pd // 4)
    conv(f"{md}.output_upscaling.3", pd // 8, pd // 4, 2, transposed=True)
    for i in range(nm):
        dims = [pd, pd, pd, pd // 8]
        for j in range(3):
            lin(f"{md}.output_hypernetworks_mlps.{i}.layers.{j}", dims[j + 1], dims[j])
    hid = model["iou_head_hidden_dim"]
    dims = [pd] + [hid] * (model["iou_head_depth"] - 1) + [nm]
    for j in range(model["iou_head_depth"]):
        lin(f"{md}.iou_prediction_head.layers.{j}", dims[j + 1], dims[j])
    return out


def _hyper_output(key: str) -> bool:
    return key.startswith("mask_decoder.output_hypernetworks_mlps.") and ".layers.2." in key


def synthetic_state(seed: int, model: dict, device="cpu") -> dict[str, torch.Tensor]:
    """Seeded float32 weights in :func:`state_layout`'s layout, drawn on
    ``device`` from one ``torch.Generator`` (the same seed and device type
    give the same weights): see the module docstring for the draws."""
    gen = torch.Generator(device=device).manual_seed((int(seed) ^ SALT) & (2**63 - 1))
    out = {}
    for key, (shape, kind, fan) in state_layout(model).items():
        t = torch.empty(shape, dtype=torch.float32, device=device)
        if kind in ("linear", "conv"):
            bound = 1.0 / math.sqrt(fan)
            t.uniform_(-bound, bound, generator=gen)
        elif kind == "ln":
            t.fill_(1.0 if key.endswith("weight") else 0.0)
        elif kind == "embed":
            t.normal_(0.0, 1.0, generator=gen)
        else:
            t.normal_(0.0, REL_POS_STD if kind == "rel_pos" else POS_EMBED_STD, generator=gen)
        if key == "mask_decoder.output_upscaling.3.weight" or (
                _hyper_output(key) and key.endswith("weight")):
            t.mul_(HEAD_SCALE)
        if _hyper_output(key):  # no common offset over the 4s' channels
            t.sub_(t.mean(dim=0, keepdim=True))
        out[key] = t
    return out


# ── the image: OpenCV's resize, the predictor's preprocessing ────────────


def _taps(n_in: int, n_out: int, edge: bool, dev):
    """OpenCV's source indices and 11-bit weights along one axis:
    ``fx = float((d + 0.5)·scale − 0.5)``, ``sx = floor(fx)``; along x
    (``edge``) a tap past either border takes the border pixel alone, along
    y the two rows are clipped to the image."""
    fx = ((torch.arange(n_out, dtype=torch.float64, device=dev) + 0.5) * (n_in / n_out)
          - 0.5).to(torch.float32)
    sx = torch.floor(fx)
    fx = fx - sx
    sx = sx.to(torch.int64)
    if edge:
        out = (sx < 0) | (sx >= n_in - 1)
        fx = torch.where(out, 0.0, fx)
        sx = torch.where(sx < 0, 0, torch.where(sx >= n_in - 1, n_in - 1, sx))
    scale = float(1 << COEF_BITS)
    w0 = torch.round((1.0 - fx) * scale).to(torch.int32)
    w1 = torch.round(fx * scale).to(torch.int32)
    return sx.clamp(0, n_in - 1), (sx + 1).clamp(0, n_in - 1), w0, w1


def resize_linear_u8(img: torch.Tensor, nw: int, nh: int) -> torch.Tensor:
    """``cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)`` of a
    uint8 ``[H, W, C]`` image: each row blended along x in integers
    (``S[x0]·a0 + S[x1]·a1``), then the rows by the vectorised blend,
    ``((r0 >> 4)·b0 >> 16) + ((r1 >> 4)·b1 >> 16)``, rounded by
    ``(v + 2) >> 2`` and saturated."""
    h, w = img.shape[:2]
    x0, x1, a0, a1 = _taps(w, nw, True, img.device)
    y0, y1, b0, b1 = _taps(h, nh, False, img.device)
    src = img.to(torch.int32)
    rows = src[:, x0] * a0[None, :, None] + src[:, x1] * a1[None, :, None]
    v = ((rows[y0] >> 4) * b0[:, None, None] >> 16) + ((rows[y1] >> 4) * b1[:, None, None] >> 16)
    return ((v + 2) >> 2).clamp(0, 255).to(torch.uint8)


def preprocess_shape(h: int, w: int, target: int) -> tuple[int, int]:
    """ResizeLongestSide.get_preprocess_shape."""
    scale = target * 1.0 / max(h, w)
    return int(h * scale + 0.5), int(w * scale + 0.5)


def preprocess(frame: torch.Tensor, img_size: int) -> torch.Tensor:
    """A uint8 ``[H, W, 3]`` frame → ``[3, S, S]``: the longest side
    resized, then ``Sam.preprocess`` (normalised, zero-padded right and
    bottom)."""
    nh, nw = preprocess_shape(frame.shape[0], frame.shape[1], img_size)
    x = resize_linear_u8(frame, nw, nh).permute(2, 0, 1).contiguous()
    mean = torch.tensor(PIXEL_MEAN, device=frame.device).view(-1, 1, 1)
    std = torch.tensor(PIXEL_STD, device=frame.device).view(-1, 1, 1)
    x = (x - mean) / std
    return F.pad(x, (0, img_size - nw, 0, img_size - nh))


# ── the image encoder ─────────────────────────────────────────────────────


def _lin(st, name, x):
    return F.linear(x, st[f"{name}.weight"], st.get(f"{name}.bias"))


def layer_norm_2d(st, name, x, eps=ENC_EPS):
    """common.py LayerNorm2d: over the channels of an NCHW map."""
    u = x.mean(1, keepdim=True)
    s = (x - u).pow(2).mean(1, keepdim=True)
    x = (x - u) / torch.sqrt(s + eps)
    return st[f"{name}.weight"][:, None, None] * x + st[f"{name}.bias"][:, None, None]


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """The ``[q, k, c]`` table; a table is held at its trained length,
    2·max(q, k) − 1, so the published resize of another length never runs."""
    if rel_pos.shape[0] != 2 * max(q_size, k_size) - 1:
        raise ValueError(f"a relative-position table of {rel_pos.shape[0]} for {q_size}")
    q_coords = torch.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    relative = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[relative.long().to(rel_pos.device)]


def add_decomposed_rel_pos(attn, q, rel_pos_h, rel_pos_w, q_size, k_size):
    q_h, q_w = q_size
    k_h, k_w = k_size
    rh = get_rel_pos(q_h, k_h, rel_pos_h)
    rw = get_rel_pos(q_w, k_w, rel_pos_w)
    b, _, dim = q.shape
    r_q = q.reshape(b, q_h, q_w, dim)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, rh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, rw)
    attn = (attn.view(b, q_h, q_w, k_h, k_w) + rel_h[:, :, :, :, None]
            + rel_w[:, :, :, None, :])
    return attn.view(b, q_h * q_w, k_h * k_w)


def attention(st, pre, x, heads: int, use_rel_pos: bool):
    b, h, w, _ = x.shape
    qkv = _lin(st, f"{pre}.qkv", x).reshape(b, h * w, 3, heads, -1).permute(2, 0, 3, 1, 4)
    q, k, v = qkv.reshape(3, b * heads, h * w, -1).unbind(0)
    attn = (q * (q.shape[-1] ** -0.5)) @ k.transpose(-2, -1)
    if use_rel_pos:
        attn = add_decomposed_rel_pos(attn, q, st[f"{pre}.rel_pos_h"], st[f"{pre}.rel_pos_w"],
                                      (h, w), (h, w))
    attn = attn.softmax(dim=-1)
    x = (attn @ v).view(b, heads, h, w, -1).permute(0, 2, 3, 1, 4).reshape(b, h, w, -1)
    return _lin(st, f"{pre}.proj", x)


def window_partition(x: torch.Tensor, ws: int):
    b, h, w, c = x.shape
    pad_h, pad_w = (ws - h % ws) % ws, (ws - w % ws) % ws
    if pad_h > 0 or pad_w > 0:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.view(b, hp // ws, ws, wp // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, ws, ws, c), (hp, wp)


def window_unpartition(windows, ws: int, pad_hw, hw):
    hp, wp = pad_hw
    h, w = hw
    b = windows.shape[0] // (hp * wp // ws // ws)
    x = windows.view(b, hp // ws, wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, hp, wp, -1)
    if hp > h or wp > w:
        x = x[:, :h, :w, :].contiguous()
    return x


def block(st, pre, x, model: dict, ws: int):
    shortcut = x
    x = F.layer_norm(x, x.shape[-1:], st[f"{pre}.norm1.weight"], st[f"{pre}.norm1.bias"], ENC_EPS)
    if ws > 0:
        h, w = x.shape[1], x.shape[2]
        x, pad_hw = window_partition(x, ws)
    x = attention(st, f"{pre}.attn", x, model["encoder_num_heads"], model["use_rel_pos"])
    if ws > 0:
        x = window_unpartition(x, ws, pad_hw, (h, w))
    x = shortcut + x
    y = F.layer_norm(x, x.shape[-1:], st[f"{pre}.norm2.weight"], st[f"{pre}.norm2.bias"], ENC_EPS)
    return x + _lin(st, f"{pre}.mlp.lin2", F.gelu(_lin(st, f"{pre}.mlp.lin1", y)))


def image_encoder(st, x: torch.Tensor, model: dict) -> torch.Tensor:
    """``[B, 3, S, S]`` → ``[B, prompt_embed_dim, S/16, S/16]``."""
    enc = "image_encoder"
    p = model["vit_patch_size"]
    x = F.conv2d(x, st[f"{enc}.patch_embed.proj.weight"], st[f"{enc}.patch_embed.proj.bias"],
                 stride=p).permute(0, 2, 3, 1)
    x = x + st[f"{enc}.pos_embed"]
    for i in range(model["encoder_depth"]):
        ws = 0 if i in model["encoder_global_attn_indexes"] else model["window_size"]
        x = block(st, f"{enc}.blocks.{i}", x, model, ws)
    x = F.conv2d(x.permute(0, 3, 1, 2), st[f"{enc}.neck.0.weight"])
    x = layer_norm_2d(st, f"{enc}.neck.1", x)
    x = F.conv2d(x, st[f"{enc}.neck.2.weight"], padding=1)
    return layer_norm_2d(st, f"{enc}.neck.3", x)


# ── the prompt encoder and the mask decoder ──────────────────────────────


def pe_encoding(st, coords: torch.Tensor) -> torch.Tensor:
    coords = 2 * coords - 1
    coords = coords @ st["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"]
    coords = 2 * math.pi * coords
    return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)


def dense_pe(st, size: int, dev) -> torch.Tensor:
    """``[1, C, s, s]`` (PositionEmbeddingRandom.forward)."""
    grid = torch.ones((size, size), device=dev, dtype=torch.float32)
    y_embed = (grid.cumsum(dim=0) - 0.5) / size
    x_embed = (grid.cumsum(dim=1) - 0.5) / size
    return pe_encoding(st, torch.stack([x_embed, y_embed], dim=-1)).permute(2, 0, 1)[None]


def embed_boxes(st, boxes: torch.Tensor, img_size: int) -> torch.Tensor:
    coords = (boxes + 0.5).reshape(-1, 2, 2).clone()
    coords[:, :, 0] = coords[:, :, 0] / img_size
    coords[:, :, 1] = coords[:, :, 1] / img_size
    corner = pe_encoding(st, coords.to(torch.float))
    corner[:, 0, :] += st["prompt_encoder.point_embeddings.2.weight"][0]
    corner[:, 1, :] += st["prompt_encoder.point_embeddings.3.weight"][0]
    return corner


def dec_attention(st, pre, q, k, v, heads: int):
    q, k, v = (_lin(st, f"{pre}.{n}", t) for n, t in (("q_proj", q), ("k_proj", k),
                                                       ("v_proj", v)))

    def separate(x):
        b, n, c = x.shape
        return x.reshape(b, n, heads, c // heads).transpose(1, 2)

    q, k, v = separate(q), separate(k), separate(v)
    attn = q @ k.permute(0, 1, 3, 2) / math.sqrt(q.shape[-1])
    out = torch.softmax(attn, dim=-1) @ v
    b, nh, n, c = out.shape
    return _lin(st, f"{pre}.out_proj", out.transpose(1, 2).reshape(b, n, nh * c))


def _dln(st, name, x):
    return F.layer_norm(x, x.shape[-1:], st[f"{name}.weight"], st[f"{name}.bias"], DEC_EPS)


def two_way_transformer(st, image, image_pe, tokens, model: dict):
    heads = model["decoder_num_heads"]
    pre = "mask_decoder.transformer"
    keys = image.flatten(2).permute(0, 2, 1)
    key_pe = image_pe.flatten(2).permute(0, 2, 1)
    queries = tokens
    for i in range(model["decoder_depth"]):
        lay = f"{pre}.layers.{i}"
        if i == 0:  # skip_first_layer_pe
            queries = dec_attention(st, f"{lay}.self_attn", queries, queries, queries, heads)
        else:
            q = queries + tokens
            queries = queries + dec_attention(st, f"{lay}.self_attn", q, q, queries, heads)
        queries = _dln(st, f"{lay}.norm1", queries)
        q, k = queries + tokens, keys + key_pe
        queries = queries + dec_attention(st, f"{lay}.cross_attn_token_to_image", q, k, keys,
                                          heads)
        queries = _dln(st, f"{lay}.norm2", queries)
        mlp = _lin(st, f"{lay}.mlp.lin2", F.relu(_lin(st, f"{lay}.mlp.lin1", queries)))
        queries = _dln(st, f"{lay}.norm3", queries + mlp)
        q, k = queries + tokens, keys + key_pe
        keys = keys + dec_attention(st, f"{lay}.cross_attn_image_to_token", k, q, queries, heads)
        keys = _dln(st, f"{lay}.norm4", keys)
    q, k = queries + tokens, keys + key_pe
    queries = queries + dec_attention(st, f"{pre}.final_attn_token_to_image", q, k, keys, heads)
    return _dln(st, f"{pre}.norm_final_attn", queries), keys


def _mlp(st, pre, x, depth: int):
    for j in range(depth):
        x = _lin(st, f"{pre}.layers.{j}", x)
        if j < depth - 1:
            x = F.relu(x)
    return x


def mask_decoder(st, image_embedding, image_pe, sparse, dense, model: dict):
    """``MaskDecoder.predict_masks`` on one frame's ``[1, C, s, s]``
    embedding and its n prompts → (logits ``[n, nm, 4s, 4s]``, IoU
    ``[n, nm]``)."""
    md = "mask_decoder"
    nm = model["num_multimask_outputs"] + 1
    output_tokens = torch.cat([st[f"{md}.iou_token.weight"], st[f"{md}.mask_tokens.weight"]])
    output_tokens = output_tokens.unsqueeze(0).expand(sparse.size(0), -1, -1)
    tokens = torch.cat((output_tokens, sparse), dim=1)
    src = torch.repeat_interleave(image_embedding, tokens.shape[0], dim=0) + dense
    pos_src = torch.repeat_interleave(image_pe, tokens.shape[0], dim=0)
    b, c, h, w = src.shape
    hs, src = two_way_transformer(st, src, pos_src, tokens, model)
    src = src.transpose(1, 2).reshape(b, c, h, w)
    up = F.conv_transpose2d(src, st[f"{md}.output_upscaling.0.weight"],
                            st[f"{md}.output_upscaling.0.bias"], stride=2)
    up = F.gelu(layer_norm_2d(st, f"{md}.output_upscaling.1", up))
    up = F.gelu(F.conv_transpose2d(up, st[f"{md}.output_upscaling.3.weight"],
                                   st[f"{md}.output_upscaling.3.bias"], stride=2))
    hyper = torch.stack([_mlp(st, f"{md}.output_hypernetworks_mlps.{i}", hs[:, 1 + i], 3)
                         for i in range(nm)], dim=1)
    b, c, h, w = up.shape
    masks = (hyper @ up.view(b, c, h * w)).view(b, -1, h, w)
    iou = _mlp(st, f"{md}.iou_prediction_head", hs[:, 0], model["iou_head_depth"])
    return masks, iou


def postprocess_masks(low_res, input_size, original_size, img_size: int) -> torch.Tensor:
    masks = F.interpolate(low_res, (img_size, img_size), mode="bilinear", align_corners=False)
    masks = masks[..., : input_size[0], : input_size[1]]
    return F.interpolate(masks, original_size, mode="bilinear", align_corners=False)


# ── the ground-truth step ────────────────────────────────────────────────


def sam_gt(frames: torch.Tensor, boxes: torch.Tensor, box_frame: torch.Tensor, model: dict,
           st: dict, dt=torch.float32) -> dict:
    """The ground-truth step on a batch: uint8 RGB ``frames`` ``[B, H, W,
    3]``, float32 ``boxes`` ``[N, 4]`` xyxy in frame pixels, int64
    ``box_frame`` ``[N]`` → ``mask`` bool ``[B, H, W]`` (each frame's OR of
    its boxes' masks), ``low_res`` ``[N, 1, 4s, 4s]`` and ``iou`` ``[N, 1]``
    float32, in the order of ``boxes``."""
    dev = frames.device
    b, h, w = frames.shape[:3]
    img = model["image_size"]
    input_size = preprocess_shape(h, w, img)
    side = 4 * (img // model["vit_patch_size"])
    low_res = torch.zeros((boxes.shape[0], 1, side, side), device=dev)
    iou = torch.zeros((boxes.shape[0], 1), device=dev)
    mask = torch.zeros((b, h, w), dtype=torch.bool, device=dev)
    with fp32(), torch.no_grad():
        x = torch.stack([preprocess(f, img) for f in frames])
        with _mixed(dev, dt):
            emb = image_encoder(st, x, model)
            pe = dense_pe(st, emb.shape[-1], dev)
        pd = emb.shape[1]
        for f in range(b):
            idx = torch.nonzero(box_frame == f)[:, 0]
            if not len(idx):
                continue
            bx = boxes[idx].reshape(-1, 2, 2).to(torch.float).clone()
            bx[..., 0] = bx[..., 0] * (input_size[1] / w)
            bx[..., 1] = bx[..., 1] * (input_size[0] / h)
            with _mixed(dev, dt):
                sparse = embed_boxes(st, bx.reshape(-1, 4), img)
                dense = st["prompt_encoder.no_mask_embed.weight"].reshape(1, -1, 1, 1).expand(
                    len(idx), pd, emb.shape[-2], emb.shape[-1])
                masks, scores = mask_decoder(st, emb[f : f + 1], pe, sparse, dense, model)
            low_res[idx], iou[idx] = masks[:, :1].float(), scores[:, :1].float()
            up = postprocess_masks(masks[:, :1].float(), input_size, (h, w), img)
            mask[f] = (up[:, 0] > MASK_THRESHOLD).any(dim=0)
    return {"mask": mask, "low_res": low_res, "iou": iou}
