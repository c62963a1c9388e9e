"""RAFT optical flow in PyTorch: the port of :mod:`nsof_tpu.models.raft`.

Feature and context CNN encoders at 1/8 resolution, an all-pairs
correlation pyramid (or, in ``corr_mode='alternate'``, windowed
correlations against a pooled feature pyramid), iterative ConvGRU
refinement and convex-combination 8× upsampling (the reference's
core/raft.py:86-145).  The modules carry the reference's torch names
(``fnet.layer2.0.downsample.0``, ``update_block.gru.convz1``,
``update_block.mask.0``, ...), so a model's ``state_dict()`` keys are a
reference checkpoint's keys (:mod:`nsof_tpu_torch.models.convert`).

NCHW inside; :class:`RAFT` takes ``[B, H, W, 3]`` images and returns flows
``[B, H, W, 2]``, as the JAX model does.  On CUDA the update block runs
channels-last (:func:`update_layout`): its convolution weights are stored so
and every activation of a refinement keeps that layout, so cuDNN's NHWC
convolutions take them with no conversion; the mathematics is the NCHW
path's.  It reproduces the JAX model where that differs from the reference:

- strided convolutions pad ``k // 2`` on both sides, as torch does (the
  JAX model pins this against Flax's asymmetric ``'SAME'``); every other
  convolution has an odd kernel at stride 1, where ``'SAME'`` is ``k // 2``;
- normalisation eps 1e-5; ``norm='batch'`` is ``GroupNorm(planes // 8)``,
  not BatchNorm; ``'frozenbatch'`` is a per-channel affine (BatchNorm in
  eval mode with its running statistics folded in);
- the correlation pyramid pools in ceil mode by default
  (``RaftConfig.corr_pool='ceil'``), edge-padding an odd side first, so
  every level keeps at least one pixel;
- :func:`corr_lookup`'s flattened (2r+1)² window has x as its outer index
  (the reference's CorrBlock quirk, which converted weights rely on).

Pooling.  The published RAFT (core/corr.py) pools the pyramid with
``F.avg_pool2d(corr, 2, stride=2)``, floor mode: an odd side drops its last
row or column, so a 45-column target axis runs 45 → 22 → 11 → 5.  The JAX
package pools in ceil mode, which the port keeps as the default so that the
JAX-parity tests hold: 45 → 23 → 12 → 6, the odd side's last column
replicated, so a lookup near that edge reads a copy of it where the
published model reads zero.  ``corr_pool='floor'`` is the published
pooling (a published checkpoint at 1/8 sides that are odd at some level
needs it); it raises where a level would have no pixel.  Both
:func:`build_corr_pyramid` and :func:`build_fmap_pyramid` take the mode, so
the alternate lookup equals the all-pairs one in either.

The lookup is four-tap bilinear sampling with zero padding by gathers (the
JAX model's hat-selector matrix products are a TPU device for avoiding
gathers).  In test mode the flow is upsampled once, after the last
iteration; the JAX scan upsamples every iteration and keeps the last, which
is the same flow.

Training: the coordinates are detached before each lookup (the JAX model's
``stop_gradient``), so the lookup's gathers backpropagate into the
correlation pyramid and the features, not into earlier iterations'
coordinates; with ``remat`` each refinement step (lookup, update block,
upsampling) is recomputed in the backward pass (the JAX ``nn.remat`` of the
scan body).
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from nsof_tpu_torch import _build
from nsof_tpu_torch.ops.correlation import window_sample, windowed_correlation_tiled
from nsof_tpu_torch.utils.timing import span


@dataclasses.dataclass(frozen=True)
class RaftConfig:
    small: bool = False
    corr_levels: int = 4
    corr_radius: int = 4
    iters: int = 12
    # activations' type inside the encoders and the update block (autocast);
    # the correlation, coordinates and upsampling stay float32
    compute_dtype: torch.dtype = torch.float32
    # 'allpairs' builds the [B, H, W, H, W] volume once (CorrBlock);
    # 'alternate' correlates windows against a pooled fmap2 pyramid at each
    # lookup (AlternateCorrBlock, core/corr.py:63-91): O(H·W) memory
    corr_mode: str = "allpairs"
    # recompute each refinement step in the backward pass instead of storing
    # its activations (torch.utils.checkpoint): training memory for ~1 more
    # forward of the update block; no effect on inference
    remat: bool = False
    # the basic model's cnet normalisation: 'batch' (GroupNorm stand-in) or
    # 'frozenbatch' (per-channel affine, for reference checkpoints)
    cnet_norm: str = "batch"
    # the correlation pyramid's 2×2 pooling: 'ceil' (the JAX package's, odd
    # sides edge-padded first) or 'floor' (the published avg_pool2d)
    corr_pool: str = "ceil"

    @property
    def hidden_dim(self) -> int:
        return 96 if self.small else 128

    @property
    def context_dim(self) -> int:
        return 64 if self.small else 128


NORM_EPS = 1e-5


class AffineNorm(nn.Module):
    """Per-channel affine: ``BatchNorm2d.eval()`` with its running
    statistics folded into ``weight`` (scale) and ``bias``."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return x * self.weight[:, None, None] + self.bias[:, None, None]


def make_norm(kind: str, planes: int, features: int | None = None) -> nn.Module:
    """The encoders' normalisation of ``features`` channels (default
    ``planes``) in a block of ``planes``: the JAX model's ``_norm``."""
    features = features or planes
    if kind in ("group", "batch"):
        return nn.GroupNorm(planes // 8, features, eps=NORM_EPS)
    if kind == "instance":
        return nn.InstanceNorm2d(features, eps=NORM_EPS)
    if kind == "frozenbatch":
        return AffineNorm(features)
    if kind == "none":
        return nn.Identity()
    raise ValueError(f"unknown norm {kind!r}")


def _conv(cin: int, cout: int, k, stride: int = 1) -> nn.Conv2d:
    """A convolution padded ``k // 2`` on each side (odd kernels)."""
    kh, kw = (k, k) if isinstance(k, int) else k
    return nn.Conv2d(cin, cout, (kh, kw), stride=stride, padding=(kh // 2, kw // 2))


class ResidualBlock(nn.Module):
    def __init__(self, cin: int, planes: int, norm: str = "instance", stride: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, planes, 3, stride)
        self.conv2 = _conv(planes, planes, 3)
        self.norm1 = make_norm(norm, planes)
        self.norm2 = make_norm(norm, planes)
        self.downsample = None
        if stride != 1 or cin != planes:
            self.norm3 = make_norm(norm, planes)
            # registered twice, as in the reference: norm3 and downsample.1
            self.downsample = nn.Sequential(nn.Conv2d(cin, planes, 1, stride=stride), self.norm3)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BottleneckBlock(nn.Module):
    """1×1 → 3×3 (stride) → 1×1 bottleneck of RAFT-small's encoders."""

    def __init__(self, cin: int, planes: int, norm: str = "instance", stride: int = 1):
        super().__init__()
        q = planes // 4
        self.conv1 = nn.Conv2d(cin, q, 1)
        self.conv2 = _conv(q, q, 3, stride)
        self.conv3 = nn.Conv2d(q, planes, 1)
        self.norm1 = make_norm(norm, planes, q)
        self.norm2 = make_norm(norm, planes, q)
        self.norm3 = make_norm(norm, planes)
        self.downsample = None
        if stride != 1 or cin != planes:
            self.norm4 = make_norm(norm, planes)
            self.downsample = nn.Sequential(nn.Conv2d(cin, planes, 1, stride=stride), self.norm4)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        y = F.relu(self.norm3(self.conv3(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """Residual CNN encoder to 1/8 resolution (core/extractor.py:118-267)."""

    def __init__(self, output_dim: int = 256, norm: str = "instance"):
        super().__init__()
        self.conv1 = _conv(3, 64, 7, 2)
        self.norm1 = make_norm(norm, 64)
        cin = 64
        for i, (planes, stride) in enumerate([(64, 1), (96, 2), (128, 2)]):
            setattr(self, f"layer{i + 1}", nn.Sequential(
                ResidualBlock(cin, planes, norm, stride), ResidualBlock(planes, planes, norm, 1)))
            cin = planes
        self.conv2 = nn.Conv2d(128, output_dim, 1)

    def forward(self, x):
        x = F.relu(self.norm1(self.conv1(x)))
        return self.conv2(self.layer3(self.layer2(self.layer1(x))))


class SmallEncoder(nn.Module):
    """Bottleneck encoder of RAFT-small (core/extractor.py:170-267); only
    ``'instance'`` normalises its first convolution, as in the JAX model."""

    def __init__(self, output_dim: int = 128, norm: str = "instance"):
        super().__init__()
        self.conv1 = _conv(3, 32, 7, 2)
        self.norm1 = make_norm("instance" if norm == "instance" else "none", 32)
        cin = 32
        for i, (planes, stride) in enumerate([(32, 1), (64, 2), (96, 2)]):
            setattr(self, f"layer{i + 1}", nn.Sequential(
                BottleneckBlock(cin, planes, norm, stride), BottleneckBlock(planes, planes, norm, 1)))
            cin = planes
        self.conv2 = nn.Conv2d(96, output_dim, 1)

    def forward(self, x):
        x = F.relu(self.norm1(self.conv1(x)))
        return self.conv2(self.layer3(self.layer2(self.layer1(x))))


# ── correlation ───────────────────────────────────────────────────────────


def all_pairs_correlation(fmap1: torch.Tensor, fmap2: torch.Tensor) -> torch.Tensor:
    """``[B, H, W, C]`` × ``[B, H, W, C]`` → ``[B, H, W, H, W]`` / √C
    (CorrBlock.corr, core/corr.py:52-59)."""
    b, h, w, c = fmap1.shape
    corr = torch.matmul(fmap1.reshape(b, h * w, c), fmap2.reshape(b, h * w, c).transpose(1, 2))
    return corr.reshape(b, h, w, h, w) / torch.sqrt(torch.tensor(float(c)))


def _pool_ceil(x: torch.Tensor) -> torch.Tensor:
    """2×2 average pooling of ``[N, C, H, W]`` in ceil mode: an odd side is
    edge-padded first."""
    ph, pw = x.shape[-2] % 2, x.shape[-1] % 2
    if ph or pw:
        x = F.pad(x, (0, pw, 0, ph), mode="replicate")
    return F.avg_pool2d(x, 2, 2)


def _pool(x: torch.Tensor, mode: str) -> torch.Tensor:
    """2×2 average pooling of ``[N, C, H, W]``: ``'ceil'``
    (:func:`_pool_ceil`) or ``'floor'`` (``F.avg_pool2d(x, 2, 2)``, an odd
    side's last row or column dropped; raises where a side is under 2)."""
    if mode == "ceil":
        return _pool_ceil(x)
    if mode != "floor":
        raise ValueError(f"unknown corr_pool {mode!r}")
    if x.shape[-2] < 2 or x.shape[-1] < 2:
        raise ValueError(f"floor pooling of a {x.shape[-2]}x{x.shape[-1]} level leaves no "
                         "pixel: fewer correlation levels or a larger frame")
    return F.avg_pool2d(x, 2, 2)


def build_corr_pyramid(corr: torch.Tensor, num_levels: int,
                       pool: str = "ceil") -> list[torch.Tensor]:
    """Pool the target axes of ``[B, H, W, H2, W2]`` into ``num_levels``
    levels ``[B·H·W, H2ℓ, W2ℓ]`` (core/corr.py:22-27) in ``pool`` mode."""
    b, h, w, h2, w2 = corr.shape
    x = corr.reshape(b * h * w, 1, h2, w2)
    pyramid = [x[:, 0]]
    for _ in range(num_levels - 1):
        x = _pool(x, pool)
        pyramid.append(x[:, 0])
    return pyramid


def build_fmap_pyramid(fmap2: torch.Tensor, num_levels: int,
                       pool: str = "ceil") -> list[torch.Tensor]:
    """The pooled ``[B, H, W, C]`` fmap2 pyramid of the alternate lookup,
    in ``pool`` mode like :func:`build_corr_pyramid`."""
    pyr = [fmap2]
    x = fmap2.permute(0, 3, 1, 2)
    for _ in range(num_levels - 1):
        x = _pool(x, pool)
        pyr.append(x.permute(0, 2, 3, 1))
    return pyr


def bilinear_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of ``img`` ``[N, H, W, C]`` at ``(x, y)`` ``[N,
    ...]``, zero outside (grid_sample's zero padding, core/utils/utils.py:
    57-71) → ``[N, ..., C]``."""
    n, h, w, c = img.shape
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    bidx = torch.arange(n, device=img.device).reshape((n,) + (1,) * (x.ndim - 1))

    def gather(xi, yi):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        vals = img[bidx, yi.long().clamp(0, h - 1), xi.long().clamp(0, w - 1)]
        return vals * valid[..., None]

    return (gather(x0, y0) * (1 - fx) * (1 - fy) + gather(x0 + 1, y0) * fx * (1 - fy)
            + gather(x0, y0 + 1) * (1 - fx) * fy + gather(x0 + 1, y0 + 1) * fx * fy)


def corr_lookup(pyramid, coords: torch.Tensor, radius: int) -> torch.Tensor:
    """Sample (2r+1)² windows at each pyramid level (CorrBlock.__call__,
    core/corr.py:29-50).

    ``pyramid``: levels ``[B·H·W, H2ℓ, W2ℓ]``; ``coords``: ``[B, H, W, 2]``
    (x, y) target coordinates at 1/8 resolution.  Returns ``[B, H, W,
    levels·(2r+1)²]``; within a level the flattened window's outer index
    moves along x and its inner along y, as the reference's CorrBlock adds
    ``stack(meshgrid(dy, dx))`` to (x, y) coordinates."""
    b, h, w, _ = coords.shape
    crd = coords.reshape(b * h * w, 2)
    out = []
    for lvl, vol in enumerate(pyramid):
        c = crd / (2 ** lvl)
        win = window_sample(vol, c[:, 0], c[:, 1], radius)  # [Q, y, x]
        out.append(win.transpose(1, 2).reshape(b, h, w, -1))
    return torch.cat(out, dim=-1)


def alternate_corr_lookup(fmap1: torch.Tensor, fmap2_pyramid, coords: torch.Tensor,
                          radius: int) -> torch.Tensor:
    """AlternateCorrBlock's lookup (core/corr.py:63-91): per level, windowed
    correlation of the full-resolution fmap1 against the pooled fmap2 at
    coords / 2^level, each level in :func:`corr_lookup`'s window order, the
    levels concatenated and scaled by 1/√C.  Equal to :func:`corr_lookup`
    over the all-pairs pyramid (pooling the volume's target axes commutes
    with the correlation), without the volume."""
    b, h, w, c = fmap1.shape
    n = 2 * radius + 1
    out = []
    for lvl, f2 in enumerate(fmap2_pyramid):
        win = windowed_correlation_tiled(fmap1, f2, coords / (2 ** lvl), radius)
        out.append(win.reshape(b, h, w, n, n).transpose(-1, -2).reshape(b, h, w, -1))
    return torch.cat(out, dim=-1) / torch.sqrt(torch.tensor(float(c)))


# ── update block ─────────────────────────────────────────────────────────


class FlowHead(nn.Module):
    def __init__(self, cin: int = 128, hidden: int = 256):
        super().__init__()
        self.conv1 = _conv(cin, hidden, 3)
        self.conv2 = _conv(hidden, 2, 3)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class SepConvGRU(nn.Module):
    def __init__(self, hidden_dim: int = 128, input_dim: int = 256):
        super().__init__()
        cin = hidden_dim + input_dim
        for gate in "zrq":
            setattr(self, f"conv{gate}1", _conv(cin, hidden_dim, (1, 5)))
            setattr(self, f"conv{gate}2", _conv(cin, hidden_dim, (5, 1)))

    def forward(self, h, x):
        for i in ("1", "2"):
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(getattr(self, "convz" + i)(hx))
            r = torch.sigmoid(getattr(self, "convr" + i)(hx))
            q = torch.tanh(getattr(self, "convq" + i)(torch.cat([r * h, x], dim=1)))
            h = (1 - z) * h + z * q
        return h


class ConvGRU(nn.Module):
    def __init__(self, hidden_dim: int = 96, input_dim: int = 146):
        super().__init__()
        cin = hidden_dim + input_dim
        self.convz = _conv(cin, hidden_dim, 3)
        self.convr = _conv(cin, hidden_dim, 3)
        self.convq = _conv(cin, hidden_dim, 3)

    def forward(self, h, x):
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(self.convz(hx))
        r = torch.sigmoid(self.convr(hx))
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)))
        return (1 - z) * h + z * q


class BasicMotionEncoder(nn.Module):
    def __init__(self, cor_planes: int):
        super().__init__()
        self.convc1 = nn.Conv2d(cor_planes, 256, 1)
        self.convc2 = _conv(256, 192, 3)
        self.convf1 = _conv(2, 128, 7)
        self.convf2 = _conv(128, 64, 3)
        self.conv = _conv(64 + 192, 128 - 2, 3)

    def forward(self, flow, corr):
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class SmallMotionEncoder(nn.Module):
    def __init__(self, cor_planes: int):
        super().__init__()
        self.convc1 = nn.Conv2d(cor_planes, 96, 1)
        self.convf1 = _conv(2, 64, 7)
        self.convf2 = _conv(64, 32, 3)
        self.conv = _conv(128, 80, 3)

    def forward(self, flow, corr):
        cor = F.relu(self.convc1(corr))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class BasicUpdateBlock(nn.Module):
    def __init__(self, cfg: RaftConfig):
        super().__init__()
        cor_planes = cfg.corr_levels * (2 * cfg.corr_radius + 1) ** 2
        self.encoder = BasicMotionEncoder(cor_planes)
        self.gru = SepConvGRU(cfg.hidden_dim, cfg.context_dim + 128)
        self.flow_head = FlowHead(cfg.hidden_dim, 256)
        self.mask = nn.Sequential(_conv(cfg.hidden_dim, 256, 3), nn.ReLU(),
                                  nn.Conv2d(256, 64 * 9, 1))

    def forward(self, net, inp, corr, flow):
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        return net, 0.25 * self.mask(net), self.flow_head(net)


class SmallUpdateBlock(nn.Module):
    def __init__(self, cfg: RaftConfig):
        super().__init__()
        cor_planes = cfg.corr_levels * (2 * cfg.corr_radius + 1) ** 2
        self.encoder = SmallMotionEncoder(cor_planes)
        self.gru = ConvGRU(cfg.hidden_dim, cfg.context_dim + 82)
        self.flow_head = FlowHead(cfg.hidden_dim, 128)

    def forward(self, net, inp, corr, flow):
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        return net, None, self.flow_head(net)


def update_layout(device: torch.device) -> torch.memory_format:
    """The memory layout of the update block's weights and activations on
    ``device``: channels-last on CUDA, where cuDNN's convolutions are NHWC
    kernels and an NCHW tensor reaches them through a conversion each way;
    NCHW elsewhere, the CPU's path that the JAX-parity tests hold."""
    return torch.channels_last if device.type == "cuda" else torch.contiguous_format


def store_conv_weights(module: nn.Module, layout: torch.memory_format) -> None:
    """Store the weight of each convolution of ``module`` in ``layout``, in
    place: each stays the same ``Parameter`` (optimizers, ``state_dict()``
    keys and loading are unchanged) and one already so is left alone."""
    with torch.no_grad(), torch.inference_mode(False):
        for m in module.modules():
            if isinstance(m, nn.Conv2d) and not m.weight.is_contiguous(memory_format=layout):
                m.weight.data = m.weight.data.contiguous(memory_format=layout)


def coords_grid(b: int, h: int, w: int, device=None) -> torch.Tensor:
    """``[B, H, W, 2]`` (x, y) pixel-coordinate grid (core/utils/utils.py:74-77)."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([xs, ys], dim=-1).expand(b, h, w, 2)


def upsample_flow_convex(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Convex-combination 8× upsampling (RAFT.upsample_flow,
    core/raft.py:72-83): flow ``[B, 2, H, W]``, mask ``[B, 576, H, W]``
    whose channel ``k·64 + i·8 + j`` weighs neighbour k of output pixel
    (i, j) → ``[B, 2, 8H, 8W]``."""
    b, _, h, w = flow.shape
    mask = torch.softmax(mask.reshape(b, 1, 9, 8, 8, h, w), dim=2)
    up = F.unfold(8.0 * flow, (3, 3), padding=1).reshape(b, 2, 9, 1, 1, h, w)
    up = (mask * up).sum(dim=2)  # [B, 2, 8(i), 8(j), H, W]
    return up.permute(0, 1, 4, 2, 5, 3).reshape(b, 2, 8 * h, 8 * w)


def upflow8(flow: torch.Tensor) -> torch.Tensor:
    """8× bilinear upsampling of ``[B, 2, H, W]`` flow, ×8, with
    align_corners=True (core/utils/utils.py:80-82)."""
    h, w = flow.shape[-2:]
    return 8.0 * F.interpolate(flow, size=(8 * h, 8 * w), mode="bilinear", align_corners=True)


class RAFT(nn.Module):
    """Full RAFT model; call with ``[B, H, W, 3]`` uint8 or float images (H
    and W multiples of 8).

    Returns the list of per-iteration upsampled flows ``[B, H, W, 2]``
    (train mode) or the final ``(flow at 1/8 resolution, flow)`` pair (test
    mode), the reference's forward contract (core/raft.py:140-145).
    """

    def __init__(self, cfg: RaftConfig = RaftConfig()):
        super().__init__()
        self.cfg = cfg
        hdim, cdim = cfg.hidden_dim, cfg.context_dim
        if cfg.small:
            self.fnet = SmallEncoder(128, "instance")
            self.cnet = SmallEncoder(hdim + cdim, "none")
            self.update_block = SmallUpdateBlock(cfg)
        else:
            self.fnet = BasicEncoder(256, "instance")
            self.cnet = BasicEncoder(hdim + cdim, cfg.cnet_norm)
            self.update_block = BasicUpdateBlock(cfg)

    def _autocast(self, device):
        if self.cfg.compute_dtype == torch.float32:
            return contextlib.nullcontext()
        return torch.autocast(device.type, dtype=self.cfg.compute_dtype)

    @staticmethod
    def _upsample(flow: torch.Tensor, up_mask) -> torch.Tensor:
        """``[B, H, W, 2]`` flow → ``[B, 8H, 8W, 2]``."""
        f = flow.permute(0, 3, 1, 2)
        up = upflow8(f) if up_mask is None else upsample_flow_convex(f, up_mask.float())
        return up.permute(0, 2, 3, 1)

    def forward(self, image1, image2, iters: int | None = None, flow_init=None,
                test_mode: bool = False):
        cfg = self.cfg
        iters = iters or cfg.iters
        hdim = cfg.hidden_dim
        layout = update_layout(image1.device)
        # the first call on a device stores the weights; later calls find them so
        store_conv_weights(self.update_block, layout)
        with span("nsof.raft.encode"):
            img1 = (2.0 * (image1.float() / 255.0) - 1.0).permute(0, 3, 1, 2).contiguous()
            img2 = (2.0 * (image2.float() / 255.0) - 1.0).permute(0, 3, 1, 2).contiguous()
            b = img1.shape[0]
            with self._autocast(img1.device):
                fmaps = self.fnet(torch.cat([img1, img2], dim=0)).float()
                cmap = self.cnet(img1)
                net = torch.tanh(cmap[:, :hdim]).contiguous(memory_format=layout)
                inp = F.relu(cmap[:, hdim:]).contiguous(memory_format=layout)
        fmap1 = fmaps[:b].permute(0, 2, 3, 1)
        fmap2 = fmaps[b:].permute(0, 2, 3, 1)
        with span("nsof.raft.corr"):
            if cfg.corr_mode == "alternate":
                f2_pyramid = build_fmap_pyramid(fmap2, cfg.corr_levels, cfg.corr_pool)

                def lookup(coords):
                    return alternate_corr_lookup(fmap1, f2_pyramid, coords, cfg.corr_radius)
            elif cfg.corr_mode == "allpairs":
                pyramid = build_corr_pyramid(all_pairs_correlation(fmap1, fmap2),
                                             cfg.corr_levels, cfg.corr_pool)

                def lookup(coords):
                    return corr_lookup(pyramid, coords, cfg.corr_radius)
            else:
                raise ValueError(f"unknown corr_mode {cfg.corr_mode!r}")

        _, h8, w8, _ = fmap1.shape
        coords0 = coords_grid(b, h8, w8, img1.device)
        coords1 = coords0.clone()
        if flow_init is not None:
            coords1 = coords1 + flow_init

        def step(net, coords1):
            # corr and flow: channels-last views of [B, H, W, C] tensors
            with span("nsof.raft.lookup"):
                corr = lookup(coords1).permute(0, 3, 1, 2)
            with span("nsof.raft.update"):
                flow = (coords1 - coords0).permute(0, 3, 1, 2)
                with self._autocast(img1.device):
                    net, up_mask, delta = self.update_block(net, inp, corr, flow)
                coords1 = coords1 + delta.float().permute(0, 2, 3, 1)
            flow_up = None
            if not test_mode:
                with span("nsof.raft.upsample"):
                    flow_up = self._upsample(coords1 - coords0, up_mask)
            return net, up_mask, coords1, flow_up

        remat = cfg.remat and torch.is_grad_enabled()
        flows = []
        up_mask = None
        for _ in range(iters):
            coords1 = coords1.detach()
            if layout == torch.channels_last:
                _build.COUNTS["raft_update_nhwc"] += 1
            if remat:
                net, up_mask, coords1, flow_up = checkpoint(step, net, coords1, use_reentrant=False,
                                                            preserve_rng_state=False)
            else:
                net, up_mask, coords1, flow_up = step(net, coords1)
            if not test_mode:
                flows.append(flow_up)
        if test_mode:
            with span("nsof.raft.upsample"):
                flow8 = coords1 - coords0
                return flow8, self._upsample(flow8, up_mask)
        return flows


def forward_interpolate(flow) -> np.ndarray:
    """Forward-splat a ``[H, W, 2]`` flow onto the next frame's grid, holes
    filled by the nearest splatted value (the Sintel warm start,
    core/utils/utils.py:26-54).  Host-side numpy and scipy."""
    from scipy.interpolate import griddata

    flow = np.asarray(flow.cpu() if isinstance(flow, torch.Tensor) else flow)
    h, w = flow.shape[:2]
    dx, dy = flow[..., 0], flow[..., 1]
    ys, xs = np.mgrid[0:h, 0:w]
    x1 = (xs + dx).reshape(-1)
    y1 = (ys + dy).reshape(-1)
    fx = dx.reshape(-1)
    fy = dy.reshape(-1)
    valid = (x1 > 0) & (x1 < w) & (y1 > 0) & (y1 < h)
    x1, y1, fx, fy = x1[valid], y1[valid], fx[valid], fy[valid]
    if x1.size == 0:
        return np.zeros_like(flow)
    fx_i = griddata((x1, y1), fx, (xs, ys), method="nearest")
    fy_i = griddata((x1, y1), fy, (xs, ys), method="nearest")
    return np.stack([fx_i, fy_i], axis=-1).astype(np.float32)


def pad_to_multiple(img: torch.Tensor, mult: int = 8):
    """InputPadder (core/utils/utils.py:7-24): replicate-pad the H and W of
    ``[H, W, C]`` or ``[B, H, W, C]`` up to a multiple of ``mult``; returns
    ``(padded, (top, bottom, left, right))``."""
    h, w = img.shape[-3:-1] if img.ndim == 4 else img.shape[:2]
    ph, pw = (-h) % mult, (-w) % mult
    pads = (ph // 2, ph - ph // 2, pw // 2, pw - pw // 2)
    if img.ndim == 2:
        x = img[None, None]
    elif img.ndim == 3:
        x = img.permute(2, 0, 1)[None]
    else:
        x = img.permute(0, 3, 1, 2)
    dtype = x.dtype
    # replicate padding takes floating point
    x = F.pad(x.float(), (pads[2], pads[3], pads[0], pads[1]), mode="replicate").to(dtype)
    if img.ndim == 2:
        return x[0, 0], pads
    if img.ndim == 3:
        return x[0].permute(1, 2, 0), pads
    return x.permute(0, 2, 3, 1), pads


def unpad(x: torch.Tensor, pads: tuple) -> torch.Tensor:
    t, bpad, lft, rgt = pads
    h, w = x.shape[-3], x.shape[-2]
    return x[..., t: h - bpad or None, lft: w - rgt or None, :]
