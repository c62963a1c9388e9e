"""Operations of SAM's ground-truth step from the configuration's shapes alone.

The least time of one frame is its convolutions' multiply-adds at the
chip's TF32 dense peak (the configuration runs cuDNN's TF32 convolutions:
the patch embedding, the neck, the decoder's two transposed convolutions)
plus its matrix products' at the float32 peak (every Linear, the attention
products, the relative-position einsums, the decoder, the mask product run
in float32).  Softmaxes, LayerNorms, GELUs, the resizes, the Fourier
encodings (a few million multiply-adds), the threshold and the OR are not
counted: none is a convolution or a matrix product the published model
makes (its resizes are ``F.interpolate``).  Work the published model does
on padded positions is counted as it does it: a windowed block's qkv,
attention and projection run on the token grid zero-padded to whole
windows (64x64 to 70x70 at vit_h), its MLP on the grid itself; every frame
is encoded at the padded square.  Each count is ``(convolution
multiply-adds, matrix-product multiply-adds)``:

- :func:`encoder_blocks`: one frame through the image encoder, by part;
- :func:`decoder_macs`: one box through the mask decoder (all four mask
  tokens, as published);
- :func:`frame_counts`: one frame's FLOPs with the traffic's mean boxes a
  frame, and :func:`least_seconds`, their least time.
"""

from __future__ import annotations

from benchmark.roofline.raft import F32_FLOPS, TF32_FLOPS


def _up(n: int, k: int) -> int:
    """``n`` rounded up to a multiple of ``k``."""
    return -(-n // k) * k


def encoder_blocks(model: dict) -> list[tuple[str, int, int]]:
    """(name, convolution, matrix-product multiply-adds) of each part of the
    image encoder on one frame: the patch embedding; each block's Linear
    layers (qkv and the projection on the tokens it attends over, the MLP
    on the grid), its attention (QKᵀ and AV) and its two relative-position
    einsums (q·R_h, q·R_w: each query against a side's keys); the neck."""
    d, heads = model["encoder_embed_dim"], model["encoder_num_heads"]
    p = model["vit_patch_size"]
    s = model["image_size"] // p
    n, ws, mlp = s * s, model["window_size"], int(d * model["mlp_ratio"])
    pd = model["prompt_embed_dim"]
    out = [("patch_embed", n * d * 3 * p * p, 0)]
    for i in range(model["encoder_depth"]):
        if i in model["encoder_global_attn_indexes"]:
            kind, tokens, keys, side = "global", n, n, s
        else:
            kind, tokens, keys, side = "window", _up(s, ws) ** 2, ws * ws, ws
        linear = tokens * d * 4 * d + n * 2 * d * mlp
        attn = 2 * tokens * keys * d
        rel = 2 * tokens * side * d
        out.append((f"block{i}.{kind}", 0, linear + attn + rel))
    out.append(("neck", n * pd * d + n * pd * pd * 9, 0))
    return out


def decoder_macs(model: dict) -> tuple[int, int]:
    """(convolution, matrix-product) multiply-adds of one box: the two-way
    transformer over the 1 + nm output tokens and the box's 2 corners
    against the s² image tokens (self attention; token→image and
    image→token at half width; the MLP), the final token→image attention,
    the two transposed 2x2 convolutions (each output pixel takes one input
    pixel), the hypernetwork MLPs, the IoU head and the mask product."""
    pd, mlp = model["prompt_embed_dim"], model["decoder_mlp_dim"]
    nm = model["num_multimask_outputs"] + 1
    s = model["image_size"] // model["vit_patch_size"]
    t, n, half = 1 + nm + 2, s * s, pd // 2

    def token_to_image():
        return t * pd * half + 2 * n * pd * half + 2 * t * n * half + t * half * pd

    mm = 0
    for _ in range(model["decoder_depth"]):
        mm += 4 * t * pd * pd + 2 * t * t * pd  # self attention
        mm += token_to_image() + 2 * t * pd * mlp
        mm += n * pd * half + 2 * t * pd * half + 2 * n * t * half + n * half * pd
    mm += token_to_image()
    conv = (2 * s) ** 2 * (pd // 4) * pd + (4 * s) ** 2 * (pd // 8) * (pd // 4)
    hid = model["iou_head_hidden_dim"]
    mm += nm * (2 * pd * pd + pd * (pd // 8)) + pd * hid + hid * hid + hid * nm
    mm += nm * (pd // 8) * (4 * s) ** 2
    return conv, mm


def frame_counts(cfg: dict, params: dict) -> tuple[float, float]:
    """(convolution FLOPs, matrix-product FLOPs) of one frame: the encoder
    and the traffic's boxes a frame (``boxes_per_frame`` over ``batch``)
    through the decoder."""
    m = cfg["model"]
    parts = encoder_blocks(m)
    conv, mm = sum(x[1] for x in parts), sum(x[2] for x in parts)
    boxes = sum(params["boxes_per_frame"][: params["batch"]]) / params["batch"]
    dc, dm = decoder_macs(m)
    return 2.0 * (conv + boxes * dc), 2.0 * (mm + boxes * dm)


def least_seconds(cfg: dict, params: dict) -> float:
    conv, mm = frame_counts(cfg, params)
    return conv / TF32_FLOPS + mm / F32_FLOPS
