"""Operations of a FlowFormer pair from the configuration's shapes alone.

The least time of one pair of the deep ROI step is its convolutions'
multiply-adds at the chip's TF32 dense peak (the configuration runs cuDNN's
TF32 convolutions, the 1x1 ones included) plus its matrix products' at the
float32 peak (attention, the Linear layers, the cost volume and GMA run in
float32).  Softmaxes, LayerNorms, GELUs, the lookups, the sine embeddings,
the upsampling, the gate and the seg head are not counted: none is a
convolution or a matrix product.  Work the published model does on padded
positions is counted as it does it: the windowed attention on the grid
padded to whole 7x7 windows, the vertical global block's queries on the
grid padded to a multiple of 4, each cost map padded to a multiple of 8.
Every image runs at the window's size padded to a multiple of 8, whatever
its box, so every pair costs the same.  Each count is ``(convolution
multiply-adds, matrix-product multiply-adds)``:

- :func:`twins_blocks`: one image through a Twins encoder, by part (the
  context encoder sees the first image, the feature encoder both);
- :func:`cost_map_macs`: one cost map's patch embedding;
- :func:`memory_macs`: the latent tokens of one pair (the cross attention
  into each map's patches, the self and vertical layers);
- :func:`step_macs`: one decoder step at one 1/8 position, GMA's
  aggregation over ``positions`` included;
- :func:`pair_counts`: one pair's FLOPs, and :func:`least_seconds`, their
  least time.
"""

from __future__ import annotations

from benchmark.roofline.raft import F32_FLOPS, TF32_FLOPS, padded

# Twins-SVT-large's first two stages: (patch, dim, heads, sr); window 7
TWINS_STAGES = ((4, 128, 4, 8), (2, 256, 8, 4))
WS = 7
VERT_SR = 4
RADIUS = 4
HIDDEN = 128
CONTEXT_DIM = 256


def _up(n: int, k: int) -> int:
    """``n`` rounded up to a multiple of ``k``."""
    return -(-n // k) * k


def _windows(h: int, w: int, c: int, c_qk: int, c_v: int) -> tuple[int, int]:
    """(projection, attention) multiply-adds of a windowed attention over an
    ``h`` × ``w`` grid padded to whole windows: q and k from ``c_qk``
    channels, v from ``c_v``, all to ``c``."""
    hp, wp = _up(h, WS), _up(w, WS)
    proj = hp * wp * c * (2 * c_qk + c_v)
    attn = (hp // WS) * (wp // WS) * 2 * (WS * WS) ** 2 * c
    return proj, attn


def twins_blocks(h: int, w: int) -> list[tuple[str, int, int]]:
    """(name, convolution, matrix-product multiply-adds) of each part of a
    Twins encoder on an ``h`` × ``w`` image: per stage the patch embedding,
    the LSA block (qkv, window attention, proj, MLP), the PEG, the GSA block
    (q, the unpadded sr convolution, kv, attention, proj, MLP)."""
    out, cin = [], 3
    for i, (patch, c, _, sr) in enumerate(TWINS_STAGES):
        h, w = h // patch, w // patch
        n = h * w
        out.append((f"stage{i}.patch_embed", n * c * cin * patch * patch, 0))
        proj, attn = _windows(h, w, c, c, c)
        out.append((f"stage{i}.lsa", 0, proj + attn + n * c * c + 8 * n * c * c))
        out.append((f"stage{i}.peg", n * c * 9, 0))
        m = (h // sr) * (w // sr)
        out.append((f"stage{i}.gsa", m * c * c * sr * sr,
                    n * c * c + m * c * 2 * c + 2 * n * m * c + n * c * c + 8 * n * c * c))
        cin = c
    return out


def twins_macs(h: int, w: int) -> tuple[int, int]:
    parts = twins_blocks(h, w)
    return sum(p[1] for p in parts), sum(p[2] for p in parts)


def cost_map_macs(h2: int, w2: int, model: dict) -> int:
    """Convolution multiply-adds of one ``h2`` × ``w2`` cost map's patch
    embedding: padded to multiples of 8, three stride-2 6x6 convolutions
    (1 → d/4 → d/2 → d), the 1x1 coordinate FFN (2d → 2d, twice)."""
    d = model["cost_latent_input_dim"]
    h, w = _up(h2, 8), _up(w2, 8)
    macs, cin = 0, 1
    for cout in (d // 4, d // 2, d):
        h, w = h // 2, w // 2
        macs += h * w * cout * cin * 36
        cin = cout
    return macs + 2 * h * w * (2 * d) ** 2


def memory_macs(h1: int, w1: int, model: dict) -> tuple[int, int]:
    """(convolution, matrix-product) multiply-adds of one pair's latent
    tokens on an ``h1`` × ``w1`` grid: each map's cross attention of the K
    tokens into its patches (the tokens' query projection once), then per
    layer the self attention at every position and the vertical local and
    global blocks on each of the K token maps (the context's projection
    once a block)."""
    k, d = model["cost_latent_token_num"], model["cost_latent_dim"]
    vc = model["vert_c_dim"]
    n = h1 * w1
    h3, w3 = _up(h1, 8) // 8, _up(w1, 8) // 8
    p, t = h3 * w3, 2 * model["cost_latent_input_dim"]
    mm = k * d * d  # the latent tokens' query projection
    mm += n * (2 * p * t * d + 2 * k * p * d + k * d * d + 2 * k * d * d)
    layer = n * (4 * k * d * d + 2 * k * k * d + 2 * k * d * d)
    conv = 0
    proj, attn = _windows(h1, w1, d, d + vc, d)
    local = proj + attn + n * d * d + 8 * n * d * d
    hp, wp = _up(h1, VERT_SR), _up(w1, VERT_SR)
    m = (hp // VERT_SR) * (wp // VERT_SR)
    glob = hp * wp * (d + vc) * d + 2 * m * d * d + 2 * hp * wp * m * d + n * d * d + 8 * n * d * d
    sr = m * d * (2 * d + vc) * VERT_SR * VERT_SR
    for _ in range(model["encoder_depth"]):
        mm += layer + k * (local + glob) + 2 * n * CONTEXT_DIM * vc
        conv += k * sr
    return conv, mm


def step_macs(model: dict, positions: int) -> tuple[int, int]:
    """(convolution, matrix-product) multiply-adds of one decoder step at
    one 1/8 position: the flow-token encoder; the cross attention (q, the
    attention over the K memory tokens, the projection of [attended,
    query], the FFN); the motion encoder; GMA's value projection and its
    aggregation over ``positions``; the SepConvGRU; the flow and mask
    heads."""
    q, k = model["query_latent_dim"], model["cost_latent_token_num"]
    win = (2 * RADIUS + 1) ** 2
    cor = q if model["only_global"] else q + win
    token = win * q + q * q
    motion = cor * 256 + 256 * 192 * 9 + 2 * 128 * 49 + 128 * 64 * 9 + 256 * 126 * 9
    gru = 6 * (HIDDEN + 3 * HIDDEN) * HIDDEN * 5
    heads = HIDDEN * 256 * 9 + 256 * 2 * 9 + HIDDEN * 256 * 9 + 256 * 576
    conv = token + motion + HIDDEN * HIDDEN + gru + heads
    cross = q * q + 2 * k * q + 2 * q * q + 2 * q * q
    return conv, cross + positions * HIDDEN


def pair_counts(cfg: dict) -> tuple[float, float]:
    """(convolution FLOPs, matrix-product FLOPs) of one pair: the context
    encoder on the first image, the feature encoder on both and the channel
    convertor, the cost volume, every cost map's patch embedding, the
    latent tokens, the decoder's k/v of them, the context projection, GMA's
    attention map, ``decoder_depth`` steps at every 1/8 position."""
    m = cfg["model"]
    h, w = padded(cfg)
    h1, w1 = h // 8, w // 8
    n = h1 * w1
    tc, tm = twins_macs(h, w)
    latent, d = m["encoder_latent_dim"], m["cost_latent_dim"]
    conv = 3 * tc + 2 * n * 256 * latent + n * cost_map_macs(h1, w1, m)
    mm = 3 * tm + n * n * latent
    mc, mmm = memory_macs(h1, w1, m)
    conv += mc
    mm += mmm + 2 * n * m["cost_latent_token_num"] * d * m["query_latent_dim"]
    conv += n * CONTEXT_DIM * CONTEXT_DIM + n * HIDDEN * 2 * HIDDEN
    mm += n * n * HIDDEN
    sc, sm = step_macs(m, n)
    conv += m["decoder_depth"] * n * sc
    mm += m["decoder_depth"] * n * sm
    return 2.0 * conv, 2.0 * mm


def least_seconds(cfg: dict) -> float:
    conv, mm = pair_counts(cfg)
    return conv / TF32_FLOPS + mm / F32_FLOPS
