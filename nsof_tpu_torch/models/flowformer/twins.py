"""Twins-SVT backbone (first two stages) in PyTorch: the port of
:mod:`nsof_tpu.models.flowformer.twins`.

FlowFormer's feature and context encoders are the first two stages of
timm's ``twins_svt_large`` (FlowFormer-Official core/FlowFormer/
encoders.py:6-35): patch-embed 4× → 2 blocks at 128 channels / 4 heads →
patch-embed 2× → 2 blocks at 256 / 8, giving 256-dim features at 1/8
resolution.  Each stage alternates locally-grouped window attention (LSA,
ws = 7) and global sub-sampled attention (GSA, sr_ratio 8 then 4), with a
PEG positional depthwise convolution after its first block.

The trunk sits under ``svt`` with timm's names (``svt.patch_embeds.0.proj``,
``svt.blocks.1.0.attn.qkv``, ``svt.pos_block.0.proj.0``, GSA's fused
``attn.kv``), so reference checkpoints load as they are.  Activations are
channels-last ``[B, H, W, C]``, as in the JAX model; the convolutions pad as
Flax's ``'SAME'`` does (:class:`SameConv2d`).

GSA's sub-sampling convolution (``attn.sr``, kernel = stride = sr) has two
modes, ``gsa_pad``: ``'same'`` (the default, the JAX package's) keeps
⌈side / sr⌉ keys a side, the grid padded as ``'SAME'`` pads (low and high);
``'valid'`` is the published one, timm's ``GlobalSubSampleAttn.sr =
nn.Conv2d(dim, dim, kernel_size=sr_ratio, stride=sr_ratio)`` with no
padding: ⌊side / sr⌋ keys, the trailing rows and columns unused.  The two
agree where each stage's grid is a multiple of its sr; at 640×360 (a
160×90 grid at sr 8, then 80×45 at sr 4) they do not.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from einops import rearrange
from torch import nn


class SameConv2d(nn.Conv2d):
    """A convolution padded as Flax's ``'SAME'``: the output is ⌈in /
    stride⌉, the padding's odd pixel (if any) on the high side."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, groups: int = 1,
                 bias: bool = True):
        super().__init__(cin, cout, k, stride=stride, groups=groups, bias=bias)

    def forward(self, x):
        pads = []
        for size, k, s in zip(x.shape[:1:-1], self.kernel_size[::-1], self.stride[::-1]):
            total = max((math.ceil(size / s) - 1) * s + k - size, 0)
            pads += [total // 2, total - total // 2]
        return super().forward(F.pad(x, pads) if any(pads) else x)


def conv_nhwc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``conv`` on a channels-last ``[B, H, W, C]`` tensor."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """``softmax((q · scale) kᵀ) v`` over the last two axes."""
    return torch.softmax(torch.matmul(q * scale, k.transpose(-1, -2)), dim=-1) @ v


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class LocallyGroupedAttn(nn.Module):
    """LSA: full attention within non-overlapping ws×ws windows, the input
    zero-padded to whole windows."""

    def __init__(self, dim: int, num_heads: int, ws: int = 7):
        super().__init__()
        self.num_heads, self.ws = num_heads, ws
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, h, w, c = x.shape
        ws = self.ws
        xp = F.pad(x, (0, 0, 0, (-w) % ws, 0, (-h) % ws))
        hp = xp.shape[1]
        qkv = rearrange(self.qkv(xp),
                        "b (nh ws1) (nw ws2) (three hd d) -> three (b nh nw) hd (ws1 ws2) d",
                        ws1=ws, ws2=ws, three=3, hd=self.num_heads)
        out = attend(qkv[0], qkv[1], qkv[2], (c // self.num_heads) ** -0.5)
        out = rearrange(out, "(b nh nw) hd (ws1 ws2) d -> b (nh ws1) (nw ws2) (hd d)",
                        b=b, nh=hp // ws, ws1=ws)
        return self.proj(out[:, :h, :w])


class GlobalSubSampleAttn(nn.Module):
    """GSA: queries attend to an sr_ratio-subsampled key/value summary; the
    summary's convolution pads as ``pad`` says (``'same'`` or ``'valid'``,
    see the module's docstring)."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int, pad: str = "same"):
        super().__init__()
        if pad not in ("same", "valid"):
            raise ValueError(f"gsa_pad must be 'same' or 'valid', not {pad!r}")
        self.num_heads, self.sr_ratio, self.pad = num_heads, sr_ratio, pad
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)
        if sr_ratio > 1:
            conv = SameConv2d if pad == "same" else nn.Conv2d
            self.sr = conv(dim, dim, sr_ratio, sr_ratio)
            self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x):
        b, h, w, c = x.shape
        if self.pad == "valid" and self.sr_ratio > min(h, w):
            raise ValueError(f"gsa_pad='valid' keeps no key of a {h}x{w} grid at sr "
                             f"{self.sr_ratio}")
        kv_in = self.norm(conv_nhwc(self.sr, x)) if self.sr_ratio > 1 else x
        k, v = self.kv(kv_in).split(c, dim=-1)
        heads = "b x y (h d) -> b h (x y) d"
        out = attend(rearrange(self.q(x), heads, h=self.num_heads),
                     rearrange(k, heads, h=self.num_heads),
                     rearrange(v, heads, h=self.num_heads), (c // self.num_heads) ** -0.5)
        return self.proj(rearrange(out, "b h (x y) d -> b x y (h d)", x=h))


class Block(nn.Module):
    """A Twins block: LSA when ``ws > 1``, else GSA, then the MLP."""

    def __init__(self, dim: int, num_heads: int, ws: int, sr_ratio: int, mlp_ratio: int = 4,
                 gsa_pad: str = "same"):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = (GlobalSubSampleAttn(dim, num_heads, sr_ratio, gsa_pad) if ws == 1
                     else LocallyGroupedAttn(dim, num_heads, ws))
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, dim * mlp_ratio, dim)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, cin: int, dim: int, patch: int):
        super().__init__()
        self.proj = SameConv2d(cin, dim, patch, patch)
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x):
        return self.norm(conv_nhwc(self.proj, x))


class PosConv(nn.Module):
    """PEG positional encoding: a residual depthwise 3×3 convolution."""

    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Sequential(nn.Conv2d(dim, dim, 3, padding=1, groups=dim))

    def forward(self, x):
        return x + conv_nhwc(self.proj, x)


class _Trunk(nn.Module):
    """timm's Twins trunk, first two stages: dims 128 → 256, heads 4 → 8,
    sr 8 → 4, depths 2 + 2, ws 7."""

    def __init__(self, gsa_pad: str = "same"):
        super().__init__()
        stages = [(3, 128, 4, 4, 8), (128, 256, 2, 8, 4)]
        self.patch_embeds = nn.ModuleList(PatchEmbed(cin, d, p) for cin, d, p, _, _ in stages)
        self.pos_block = nn.ModuleList(PosConv(d) for _, d, _, _, _ in stages)
        self.blocks = nn.ModuleList(
            nn.ModuleList(Block(d, heads, 7 if j % 2 == 0 else 1, sr, gsa_pad=gsa_pad)
                          for j in range(2))
            for _, d, _, heads, sr in stages)

    def forward(self, x):
        for embed, blocks, peg in zip(self.patch_embeds, self.blocks, self.pos_block):
            x = embed(x)
            for j, blk in enumerate(blocks):
                x = blk(x)
                if j == 0:
                    x = peg(x)
        return x


class TwinsSVTLarge2Stage(nn.Module):
    """``[B, H, W, 3]`` → ``[B, H/8, W/8, 256]``; ``gsa_pad`` as in the
    module's docstring."""

    def __init__(self, gsa_pad: str = "same"):
        super().__init__()
        self.svt = _Trunk(gsa_pad)

    def forward(self, x):
        return self.svt(x)
