"""Operations of a RAFT-basic pair from the configuration's shapes alone.

The least time of one pair of the deep ROI step is its convolutions'
multiply-adds at the chip's TF32 dense peak (the configuration runs cuDNN's
TF32 convolutions) plus the all-pairs correlation's at the float32 peak
(its matrix product runs in float32).  The lookups, the pooling, the
upsampling, the gate and the seg head are not counted: none is a
convolution or a matrix product, and together they are a small share of
the operations.  Every image runs at the window's size padded to a
multiple of 8, whatever its box, so every pair costs the same:

- :func:`encoder_macs`: one image through a basic encoder (the feature
  and the context encoders have the same convolutions);
- :func:`update_macs`: one refinement at one 1/8 position (the motion
  encoder, the SepConvGRU, the flow head and the mask head);
- :func:`pair_counts`: one pair's convolution and correlation FLOPs, and
  :func:`least_seconds`, their least time.
"""

from __future__ import annotations

# NVIDIA H100 SXM, published dense peaks at 700 W
TF32_FLOPS = 494.7e12
F32_FLOPS = 67e12
ENCODER_LAYERS = ((64, 1), (96, 2), (128, 2))  # (planes, stride) of the three layers


def conv_out(n: int, k: int, stride: int) -> int:
    """A side after a convolution of kernel ``k`` padded ``k // 2``."""
    return (n + 2 * (k // 2) - k) // stride + 1


def padded(cfg: dict) -> tuple[int, int]:
    """The window's (rows, columns) padded to multiples of 8."""
    h = cfg["window_h"] or cfg["image_h"]
    w = cfg["window_w"] or cfg["image_w"]
    return h + (-h) % 8, w + (-w) % 8


def encoder_blocks(h: int, w: int, out_dim: int) -> list[tuple[str, int]]:
    """(name, multiply-adds) of each stage of a basic encoder on an
    ``h`` × ``w`` image: the stem, each residual block (its two 3×3
    convolutions and a strided block's 1×1 downsampling), the output 1×1."""
    h, w = conv_out(h, 7, 2), conv_out(w, 7, 2)
    out = [("conv1", h * w * 64 * 3 * 49)]
    cin = 64
    for i, (planes, stride) in enumerate(ENCODER_LAYERS):
        for j in (0, 1):
            s = stride if j == 0 else 1
            h, w = conv_out(h, 3, s), conv_out(w, 3, s)
            macs = h * w * planes * 9 * (cin + planes)
            if s != 1:
                macs += h * w * planes * cin
            out.append((f"layer{i + 1}.{j}", macs))
            cin = planes
    out.append(("conv2", h * w * out_dim * 128))
    return out


def encoder_macs(h: int, w: int, out_dim: int) -> int:
    return sum(m for _, m in encoder_blocks(h, w, out_dim))


def update_macs(model: dict) -> int:
    """Multiply-adds of one refinement at one 1/8 position."""
    cor = model["corr_levels"] * (2 * model["corr_radius"] + 1) ** 2
    hdim, cdim = model["hidden_dim"], model["context_dim"]
    motion = cor * 256 + 256 * 192 * 9 + 2 * 128 * 49 + 128 * 64 * 9 + 256 * 126 * 9
    gru = 6 * (hdim + cdim + 128) * hdim * 5
    heads = hdim * 256 * 9 + 256 * 2 * 9 + hdim * 256 * 9 + 256 * 576
    return motion + gru + heads


def pair_counts(cfg: dict) -> tuple[float, float]:
    """(convolution FLOPs, correlation FLOPs) of one pair: both images
    through the feature encoder, the first through the context encoder,
    ``iters`` refinements at every 1/8 position, the correlation."""
    m = cfg["model"]
    h, w = padded(cfg)
    h8, w8 = h // 8, w // 8
    conv = (2 * encoder_macs(h, w, m["fnet_dim"])
            + encoder_macs(h, w, m["hidden_dim"] + m["context_dim"])
            + m["iters"] * h8 * w8 * update_macs(m))
    return 2.0 * conv, 2.0 * (h8 * w8) ** 2 * m["fnet_dim"]


def least_seconds(cfg: dict) -> float:
    conv, corr = pair_counts(cfg)
    return conv / TF32_FLOPS + corr / F32_FLOPS
