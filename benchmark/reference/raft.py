"""RAFT-basic and the deep ROI step, as the benchmark's reference.

The forward follows the published RAFT (Teed & Deng, ECCV 2020;
github.com/princeton-vl/RAFT: core/raft.py, extractor.py, corr.py,
update.py, utils/utils.py) line by line, written afresh as functions of a
state dict in the published checkpoint's layout (raft-things.pth's keys,
``module.`` prefix stripped), in plain torch:

- the feature encoder with instance norm, the context encoder with
  BatchNorm in eval mode (``F.batch_norm`` on the running statistics);
- the all-pairs correlation over √C, pooled by ``F.avg_pool2d(corr, 2,
  stride=2)`` (floor mode) into ``levels`` levels;
- the lookup through ``F.grid_sample(align_corners=True)`` with zero
  padding, the window's offsets from ``meshgrid(dy, dx)`` added to (x, y)
  as published, so the flattened window has x as its outer index;
- BasicMotionEncoder, SepConvGRU, the flow head and the 0.25-scaled mask
  head; convex 8× upsampling.

Departures from the published code:

- test mode only: the flow is upsampled once, after the last iteration
  (the published loop upsamples every iteration and returns the last,
  which is the same flow);
- a pyramid level with a side of one pixel raises (the published sampler
  divides by W − 1 there);
- under ``dt=torch.bfloat16`` the encoders and the update block run under
  bfloat16 autocast, the published ``mixed_precision`` regions, and the
  update block's outputs are taken back to float32 before the coordinates
  and the upsampling use them;
- float32 arithmetic throughout otherwise: :func:`fp32` turns TF32 off for
  both cuDNN and cuBLAS.

:func:`roi_step` adds the ROI step of raft_seg.py around it: the merged
box on the MEMSIZE/3 grid (``segmentation.gate``), active only if both of
its sides reach 64 px; the window at the box's origin clamped into the
frame; edge padding to a multiple of 8 (half above and left); the flow,
not negated, zero outside the box; the seg head (``segmentation.head``);
window and mask pasted into zero frames.  ``cfg`` is the configuration
file's dict (``benchmark/configs/raft.json``).

:func:`synthetic_state` draws weights from a seed in that layout: the
published initialisation (Kaiming-normal encoder convolutions, PyTorch's
default uniform elsewhere) with BatchNorm affines and running statistics
away from the identity.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import segmentation

MIN_REGION_PX = 64  # raft_seg.py:133-135
BN_EPS = 1e-5
# (planes, stride) of the basic encoder's three layers
ENCODER_LAYERS = ((64, 1), (96, 2), (128, 2))


# ── the state dict ────────────────────────────────────────────────────────


def state_layout(model: dict) -> dict[str, tuple]:
    """Key → shape of a RAFT-basic state dict (raft-things.pth's keys);
    BatchNorm keys of the context encoder included."""
    out = {}
    cor_planes = model["corr_levels"] * (2 * model["corr_radius"] + 1) ** 2
    hdim, cdim = model["hidden_dim"], model["context_dim"]

    def conv(name, cout, cin, kh, kw=None):
        out[f"{name}.weight"] = (cout, cin, kh, kw or kh)
        out[f"{name}.bias"] = (cout,)

    def bn(name, c):
        for k in ("weight", "bias", "running_mean", "running_var"):
            out[f"{name}.{k}"] = (c,)
        out[f"{name}.num_batches_tracked"] = ()

    for enc, dim, batch in (("fnet", model["fnet_dim"], False), ("cnet", hdim + cdim, True)):
        conv(f"{enc}.conv1", 64, 3, 7)
        if batch:
            bn(f"{enc}.norm1", 64)
        cin = 64
        for i, (planes, stride) in enumerate(ENCODER_LAYERS):
            for j in (0, 1):
                p = f"{enc}.layer{i + 1}.{j}"
                conv(f"{p}.conv1", planes, cin, 3)
                conv(f"{p}.conv2", planes, planes, 3)
                if batch:
                    bn(f"{p}.norm1", planes)
                    bn(f"{p}.norm2", planes)
                if j == 0 and stride != 1:
                    conv(f"{p}.downsample.0", planes, cin, 1)
                    if batch:  # one module, registered as norm3 and downsample.1
                        bn(f"{p}.norm3", planes)
                        bn(f"{p}.downsample.1", planes)
                cin = planes
        conv(f"{enc}.conv2", dim, 128, 1)
    u = "update_block"
    conv(f"{u}.encoder.convc1", 256, cor_planes, 1)
    conv(f"{u}.encoder.convc2", 192, 256, 3)
    conv(f"{u}.encoder.convf1", 128, 2, 7)
    conv(f"{u}.encoder.convf2", 64, 128, 3)
    conv(f"{u}.encoder.conv", 128 - 2, 64 + 192, 3)
    for g in "zrq":
        conv(f"{u}.gru.conv{g}1", hdim, hdim + cdim + 128, 1, 5)
        conv(f"{u}.gru.conv{g}2", hdim, hdim + cdim + 128, 5, 1)
    conv(f"{u}.flow_head.conv1", 256, hdim, 3)
    conv(f"{u}.flow_head.conv2", 2, 256, 3)
    conv(f"{u}.mask.0", 256, hdim, 3)
    conv(f"{u}.mask.2", 64 * 9, 256, 1)
    return out


def synthetic_state(seed: int, model: dict) -> dict[str, torch.Tensor]:
    """Seeded float32 weights in :func:`state_layout`'s layout, on the CPU."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, 0x5AF7])
    layout = state_layout(model)
    out = {}
    for key, shape in layout.items():
        name, leaf = key.rsplit(".", 1)
        batchnorm = f"{name}.running_mean" in layout
        if leaf == "num_batches_tracked":
            out[key] = torch.tensor(1000, dtype=torch.int64)
            continue
        if name.endswith("downsample.1"):  # the same module as norm3
            out[key] = out[f"{name[: -len('downsample.1')]}norm3.{leaf}"].clone()
            continue
        if batchnorm:
            v = {"weight": lambda: rng.uniform(0.7, 1.3, shape),
                 "bias": lambda: rng.normal(0.0, 0.1, shape),
                 "running_mean": lambda: rng.normal(0.0, 0.2, shape),
                 "running_var": lambda: rng.uniform(0.5, 2.0, shape)}[leaf]()
        else:
            w = layout[f"{name}.weight"]
            fan_in = w[1] * w[2] * w[3]
            if leaf == "weight" and name.startswith(("fnet", "cnet")):
                # kaiming_normal_(mode='fan_out', nonlinearity='relu')
                v = rng.standard_normal(shape) * np.sqrt(2.0 / (w[0] * w[2] * w[3]))
            else:  # PyTorch's default for weights and biases
                v = rng.uniform(-1.0, 1.0, shape) / np.sqrt(fan_in)
        out[key] = torch.from_numpy(np.asarray(v, dtype=np.float32))
    return out


# ── the forward ───────────────────────────────────────────────────────────


@contextlib.contextmanager
def fp32():
    """Float32 convolutions and matrix products: TF32 off in cuDNN and
    cuBLAS for the body, the settings restored after."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _conv(st, name, x, stride=1):
    w = st[f"{name}.weight"]
    return F.conv2d(x, w, st[f"{name}.bias"], stride=stride,
                    padding=(w.shape[2] // 2, w.shape[3] // 2))


def _norm(st, name, x, kind):
    if kind == "instance":
        return F.instance_norm(x, eps=BN_EPS)
    return F.batch_norm(x, st[f"{name}.running_mean"], st[f"{name}.running_var"],
                        st[f"{name}.weight"], st[f"{name}.bias"], training=False, eps=BN_EPS)


def encoder(st, enc: str, x: torch.Tensor, kind: str) -> torch.Tensor:
    """BasicEncoder (core/extractor.py): ``[N, 3, H, W]`` → 1/8 features."""
    x = F.relu(_norm(st, f"{enc}.norm1", _conv(st, f"{enc}.conv1", x, 2), kind))
    for i, (_, stride) in enumerate(ENCODER_LAYERS):
        for j in (0, 1):
            p = f"{enc}.layer{i + 1}.{j}"
            s = stride if j == 0 else 1
            y = F.relu(_norm(st, f"{p}.norm1", _conv(st, f"{p}.conv1", x, s), kind))
            y = F.relu(_norm(st, f"{p}.norm2", _conv(st, f"{p}.conv2", y), kind))
            if f"{p}.downsample.0.weight" in st:
                x = _norm(st, f"{p}.norm3", _conv(st, f"{p}.downsample.0", x, s), kind)
            x = F.relu(x + y)
    return _conv(st, f"{enc}.conv2", x)


def corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor, levels: int) -> list:
    """CorrBlock.__init__ (core/corr.py): ``[B, C, H, W]`` features →
    levels of ``[B·H·W, 1, H2ℓ, W2ℓ]``."""
    b, c, h, w = fmap1.shape
    corr = torch.matmul(fmap1.reshape(b, c, h * w).transpose(1, 2), fmap2.reshape(b, c, h * w))
    corr = corr.reshape(b * h * w, 1, h, w) / torch.sqrt(torch.tensor(c).float())
    out = [corr]
    for _ in range(levels - 1):
        corr = F.avg_pool2d(corr, 2, stride=2)
        out.append(corr)
    return out


def lookup(pyramid: list, coords: torch.Tensor, radius: int) -> torch.Tensor:
    """CorrBlock.__call__ with ``bilinear_sampler``: ``coords`` ``[B, 2, H,
    W]`` (x, y) → ``[B, levels·(2r+1)², H, W]``."""
    coords = coords.permute(0, 2, 3, 1)
    b, h, w, _ = coords.shape
    d = torch.linspace(-radius, radius, 2 * radius + 1, device=coords.device)
    delta = torch.stack(torch.meshgrid(d, d, indexing="ij"), dim=-1)
    out = []
    for i, corr in enumerate(pyramid):
        hl, wl = corr.shape[-2:]
        if hl < 2 or wl < 2:
            raise ValueError(f"a {hl}x{wl} correlation level: the sampler divides by its side - 1")
        pts = coords.reshape(b * h * w, 1, 1, 2) / 2 ** i + delta.view(1, 2 * radius + 1,
                                                                        2 * radius + 1, 2)
        xg, yg = pts.split([1, 1], dim=-1)
        grid = torch.cat([2 * xg / (wl - 1) - 1, 2 * yg / (hl - 1) - 1], dim=-1)
        out.append(F.grid_sample(corr, grid, align_corners=True).view(b, h, w, -1))
    return torch.cat(out, dim=-1).permute(0, 3, 1, 2).contiguous().float()


def update(st, net, inp, corr, flow):
    """BasicUpdateBlock (core/update.py) → (net, mask, delta_flow)."""
    u = "update_block"
    cor = F.relu(_conv(st, f"{u}.encoder.convc1", corr))
    cor = F.relu(_conv(st, f"{u}.encoder.convc2", cor))
    flo = F.relu(_conv(st, f"{u}.encoder.convf1", flow))
    flo = F.relu(_conv(st, f"{u}.encoder.convf2", flo))
    out = F.relu(_conv(st, f"{u}.encoder.conv", torch.cat([cor, flo], dim=1)))
    x = torch.cat([inp, out, flow], dim=1)
    h = net
    for k in "12":
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(_conv(st, f"{u}.gru.convz{k}", hx))
        r = torch.sigmoid(_conv(st, f"{u}.gru.convr{k}", hx))
        q = torch.tanh(_conv(st, f"{u}.gru.convq{k}", torch.cat([r * h, x], dim=1)))
        h = (1 - z) * h + z * q
    delta = _conv(st, f"{u}.flow_head.conv2", F.relu(_conv(st, f"{u}.flow_head.conv1", h)))
    mask = 0.25 * _conv(st, f"{u}.mask.2", F.relu(_conv(st, f"{u}.mask.0", h)))
    return h, mask, delta


def upsample_flow(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """RAFT.upsample_flow: ``[N, 2, H, W]`` → ``[N, 2, 8H, 8W]``."""
    n, _, h, w = flow.shape
    mask = torch.softmax(mask.view(n, 1, 9, 8, 8, h, w), dim=2)
    up = F.unfold(8 * flow, [3, 3], padding=1).view(n, 2, 9, 1, 1, h, w)
    up = torch.sum(mask * up, dim=2).permute(0, 1, 4, 2, 5, 3)
    return up.reshape(n, 2, 8 * h, 8 * w)


def raft_flow(st: dict, image1: torch.Tensor, image2: torch.Tensor, model: dict,
              dt=torch.float32) -> torch.Tensor:
    """The final flow ``[B, H, W, 2]`` of ``model["iters"]`` refinements on
    ``[B, H, W, 3]`` RGB frames (H, W multiples of 8)."""
    dev = image1.device
    with torch.no_grad():
        i1 = 2 * (image1.permute(0, 3, 1, 2).float() / 255.0) - 1.0
        i2 = 2 * (image2.permute(0, 3, 1, 2).float() / 255.0) - 1.0
        b = i1.shape[0]
        with _mixed(dev, dt):
            fmaps = encoder(st, "fnet", torch.cat([i1, i2], dim=0), "instance")
        fmaps = fmaps.float()
        pyramid = corr_pyramid(fmaps[:b], fmaps[b:], model["corr_levels"])
        hdim = model["hidden_dim"]
        with _mixed(dev, dt):
            cnet = encoder(st, "cnet", i1, "batch")
            net, inp = torch.tanh(cnet[:, :hdim]), torch.relu(cnet[:, hdim:])
        _, _, h8, w8 = fmaps.shape
        ys, xs = torch.meshgrid(torch.arange(h8, device=dev), torch.arange(w8, device=dev),
                                indexing="ij")
        coords0 = torch.stack([xs, ys], dim=0).float()[None].repeat(b, 1, 1, 1)
        coords1 = coords0.clone()
        mask = None
        for _ in range(model["iters"]):
            corr = lookup(pyramid, coords1, model["corr_radius"])
            flow = coords1 - coords0
            with _mixed(dev, dt):
                net, mask, delta = update(st, net, inp, corr, flow)
            coords1 = coords1 + delta.float()
        return upsample_flow(coords1 - coords0, mask.float()).permute(0, 2, 3, 1)


def _mixed(dev, dt):
    if dt == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(dev.type, dtype=dt)


# ── the ROI step ──────────────────────────────────────────────────────────


def _pad8(x: torch.Tensor) -> tuple[torch.Tensor, int, int]:
    """Edge-pad ``[B, H, W, C]`` to multiples of 8, half above and left."""
    h, w = x.shape[1:3]
    ph, pw = (-h) % 8, (-w) % 8
    y = F.pad(x.permute(0, 3, 1, 2).float(), (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2),
              mode="replicate")
    return y.permute(0, 2, 3, 1), ph // 2, pw // 2


def roi_step(mem, prev, nxt, cfg: dict, state: dict, dt=torch.float32) -> dict:
    """The deep ROI step on a batch: ``mem`` ``[B, gh, gw]`` uint8 on the
    MEMSIZE/3 grid, ``prev``/``nxt`` ``[B, H, W, 3]`` uint8 → ``flow`` [B, H,
    W, 2] float32 (zero outside the box), ``mask`` [B, H, W] uint8 {0, 255},
    ``box`` [B, 4] int32 and ``any_active`` [B] (the box active and both its
    sides ≥ 64 px).  ``state`` is on ``prev``'s device; ``dt`` the arithmetic
    of the encoders and the update block."""
    h, w = prev.shape[1:3]
    deep = dict(cfg, image_h=h, image_w=w,
                roi=dict(cfg["roi"], memsize=max(cfg["roi"]["memsize"] // 3, 1)))
    box, any_active = segmentation.gate(mem, deep)
    active = (any_active & ((box[:, 2] - box[:, 0]) >= MIN_REGION_PX)
              & ((box[:, 3] - box[:, 1]) >= MIN_REGION_PX))
    wh, ww = cfg["window_h"] or h, cfg["window_w"] or w
    oy = box[:, 1].long().clamp(0, h - wh)
    ox = box[:, 0].long().clamp(0, w - ww)
    dev = prev.device
    b = mem.shape[0]
    ys = oy[:, None, None] + torch.arange(wh, device=dev)[None, :, None]
    xs = ox[:, None, None] + torch.arange(ww, device=dev)[None, None, :]
    bi = torch.arange(b, device=dev)[:, None, None]
    p1, top, left = _pad8(prev[bi, ys, xs])
    p2, _, _ = _pad8(nxt[bi, ys, xs])
    with fp32():
        flow = raft_flow(state, p1, p2, cfg["model"], dt)[:, top: top + wh, left: left + ww]
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
