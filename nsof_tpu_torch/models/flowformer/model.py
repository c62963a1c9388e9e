"""FlowFormer top-level model and tiled inference in PyTorch: the port of
:mod:`nsof_tpu.models.flowformer.model`.

FlowFormer (transformer.py:19-48): a Twins-SVT context encoder, the memory
encoder (features of both frames → cost volume → latent tokens, with the
feature encoder inside it, as in the reference's module tree) and the
recurrent memory decoder.  The forward's spans (``utils/timing.py::span``):
``nsof.flowformer.encode`` (the input scaling, both Twins encoders, the
channel convertor, the decoder's context projection and GMA's attention
map), ``nsof.flowformer.memory`` (the cost volume, its latent tokens and
the decoder's k/v projection of them), then the decoder's per step
(``.lookup``, ``.query``, ``.update``) and ``.upsample``.  Tiled inference
at any resolution slides TRAIN_SIZE windows with a minimum overlap and
blends them with gaussian weights (visualize_flow.py:27-100).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch import nn

from nsof_tpu_torch.models.flowformer.config import (TILE_MIN_OVERLAP, TRAIN_SIZE,
                                                     FlowFormerConfig)
from nsof_tpu_torch.models.flowformer.decoder import MemoryDecoder
from nsof_tpu_torch.models.flowformer.encoder import MemoryEncoder
from nsof_tpu_torch.models.flowformer.twins import TwinsSVTLarge2Stage
from nsof_tpu_torch.utils.timing import span


class FlowFormer(nn.Module):
    def __init__(self, cfg: FlowFormerConfig = FlowFormerConfig()):
        super().__init__()
        from nsof_tpu_torch.models.raft import BasicEncoder

        self.cfg = cfg
        self.context_encoder = (TwinsSVTLarge2Stage(cfg.gsa_pad) if cfg.cnet == "twins"
                                else BasicEncoder(256, "instance"))
        self.memory_encoder = MemoryEncoder(cfg)
        self.memory_decoder = MemoryDecoder(cfg)

    def forward(self, image1, image2, flow_init=None, test_mode: bool = False):
        """``[B, H, W, 3]`` uint8 or float frames (H, W multiples of 8) →
        the list of per-step upsampled flows ``[B, H, W, 2]``, or in
        ``test_mode`` the last."""
        c = self.cfg
        dec = self.memory_decoder

        def mixed():
            return (contextlib.nullcontext() if c.compute_dtype == torch.float32
                    else torch.autocast(image1.device.type, dtype=c.compute_dtype))

        with span("nsof.flowformer.encode"):
            img1 = 2.0 * (image1.float() / 255.0) - 1.0
            img2 = 2.0 * (image2.float() / 255.0) - 1.0
            with mixed():
                if c.cnet == "twins":
                    context = self.context_encoder(img1)
                else:
                    context = self.context_encoder(img1.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
                feats = self.memory_encoder.features(torch.cat([img1, img2], dim=0))
                prep = dec.prepare(context, flow_init)
        with span("nsof.flowformer.memory"), mixed():
            cost_memory, cost_maps = self.memory_encoder(feats, context)
            kv = dec.memory_kv(cost_memory)
        with mixed():
            return dec(prep, kv, cost_maps, test_mode=test_mode)


# ── tiled inference ───────────────────────────────────────────────────────


def compute_grid_indices(image_shape, patch_size=TRAIN_SIZE, min_overlap=TILE_MIN_OVERLAP):
    """Sliding-window tile origins (visualize_flow.py:30-46)."""
    def starts(size, patch):
        if size == patch:
            return [0]
        out = list(range(0, size, patch - min_overlap))
        while out and out[-1] + patch >= size:
            out = out[:-1]
        out.append(size - patch)
        return [s for s in out if s >= 0]

    hs = starts(image_shape[0], patch_size[0])
    ws = starts(image_shape[1], patch_size[1])
    return [(h, w) for h in hs for w in ws]


def compute_weight(hws, image_shape, patch_size=TRAIN_SIZE, sigma=0.05):
    """Gaussian blend weights per tile (visualize_flow.py:49-66), each pixel's
    weights normalised to sum 1 over the tiles covering it."""
    ys, xs = np.meshgrid(np.arange(patch_size[0]), np.arange(patch_size[1]), indexing="ij")
    yc, xc = patch_size[0] / 2, patch_size[1] / 2
    g = np.exp(-(((ys - yc) / patch_size[0]) ** 2 + ((xs - xc) / patch_size[1]) ** 2)
               / (2 * sigma ** 2))
    weights = np.zeros((len(hws),) + tuple(image_shape))
    for i, (h, w) in enumerate(hws):
        weights[i, h: h + patch_size[0], w: w + patch_size[1]] = g
    total = weights.sum(axis=0, keepdims=True)
    # divide exactly: gaussian tails underflow far below any epsilon, and a
    # clamped denominator would zero single-tile image corners
    return weights / np.where(total == 0, 1.0, total)


def tiled_flow(apply_fn, image1: np.ndarray, image2: np.ndarray, patch_size=TRAIN_SIZE,
               min_overlap=TILE_MIN_OVERLAP) -> np.ndarray:
    """Full-resolution flow ``[B, H, W, 2]`` by gaussian-blended sliding
    tiles; ``apply_fn(img1_tile, img2_tile)`` returns a tile's flow ``[B,
    th, tw, 2]`` (a tensor or an array)."""
    h, w = image1.shape[1:3]
    patch_size = (min(patch_size[0], h), min(patch_size[1], w))
    hws = compute_grid_indices((h, w), patch_size, min_overlap)
    weights = compute_weight(hws, (h, w), patch_size)
    flow_acc = np.zeros(image1.shape[:1] + (h, w, 2), np.float32)
    for i, (hy, wx) in enumerate(hws):
        t1 = image1[:, hy: hy + patch_size[0], wx: wx + patch_size[1]]
        t2 = image2[:, hy: hy + patch_size[0], wx: wx + patch_size[1]]
        fl = apply_fn(t1, t2)
        fl = fl.detach().cpu().numpy() if isinstance(fl, torch.Tensor) else np.asarray(fl)
        wgt = weights[i][None, hy: hy + patch_size[0], wx: wx + patch_size[1], None]
        flow_acc[:, hy: hy + patch_size[0], wx: wx + patch_size[1]] += fl * wgt
    return flow_acc
