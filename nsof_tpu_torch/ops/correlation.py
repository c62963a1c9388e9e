"""Windowed correlation for RAFT's alternate lookup: the port of
:mod:`nsof_tpu.ops.correlation`.

The reference's ``alt_cuda_corr`` extension computes bilinear-weighted
windowed dot products on demand (alt_cuda_corr/correlation_kernel.cu:
19-119), so the [B, H, W, H2, W2] cost volume never exists whole.  Here:

- :func:`windowed_correlation` — the plain formulation, one bilinear gather
  of fmap2 and one dot product per window offset: the JAX package's
  ``windowed_correlation``;
- :func:`windowed_correlation_tiled` — the function the JAX package's
  ``windowed_correlation_mxu`` computes: per tile of query rows, the
  correlation rows ``f1_tile @ f2ᵀ`` as one matrix product, then each
  window sampled from them (:func:`window_sample`), so no more than a tile's
  rows of the volume exist at a time.

Both anchor the window at floor(coords) and spread each sample over its
four integer neighbours, with zero outside the feature map.  Both return
``[B, H, W, (2r+1)²]`` in (dy outer, dx inner) order, unscaled: the caller
divides by √C after stacking the levels, as AlternateCorrBlock does.
"""

from __future__ import annotations

import torch

# the most bytes of correlation rows a tile of windowed_correlation_tiled holds
TILE_BYTES = 1 << 28


def window_sample(vol: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor,
                  radius: int) -> torch.Tensor:
    """Bilinear samples of each ``vol[q]`` (``[Q, H2, W2]``) at ``(cx[q] +
    dx, cy[q] + dy)`` for dx, dy in [-r, r], zero outside the map →
    ``[Q, 2r+1 (dy), 2r+1 (dx)]``.

    The offsets are whole pixels, so every sample of a window shares one
    fractional part: the (2r+2)² integer-grid patch is gathered once and
    its four-tap blends are the samples."""
    q, h2, w2 = vol.shape
    x0, y0 = torch.floor(cx), torch.floor(cy)
    fx = (cx - x0)[:, None, None]
    fy = (cy - y0)[:, None, None]
    offs = torch.arange(-radius, radius + 2, device=vol.device)
    iy = y0.long()[:, None] + offs
    ix = x0.long()[:, None] + offs
    inside = ((iy >= 0) & (iy < h2))[:, :, None] & ((ix >= 0) & (ix < w2))[:, None, :]
    idx = iy.clamp(0, h2 - 1)[:, :, None] * w2 + ix.clamp(0, w2 - 1)[:, None, :]
    n1 = 2 * radius + 2
    patch = torch.gather(vol.reshape(q, h2 * w2), 1, idx.reshape(q, n1 * n1))
    patch = patch.reshape(q, n1, n1) * inside
    top = patch[:, :-1, :-1] * (1 - fx) + patch[:, :-1, 1:] * fx
    bottom = patch[:, 1:, :-1] * (1 - fx) + patch[:, 1:, 1:] * fx
    return top * (1 - fy) + bottom * fy


def windowed_correlation(fmap1: torch.Tensor, fmap2: torch.Tensor, coords: torch.Tensor,
                         radius: int) -> torch.Tensor:
    """Plain windowed correlation.

    ``fmap1`` ``[B, H, W, C]``; ``fmap2`` ``[B, H2, W2, C]`` (the same or a
    pooled resolution); ``coords`` ``[B, H, W, 2]`` (x, y) window centres in
    fmap2's pixels.  Returns ``[B, H, W, (2r+1)²]``: ⟨fmap1, bilinear(fmap2)
    at (x + dx, y + dy)⟩ for dy outer, dx inner."""
    b, h, w, c = fmap1.shape
    _, h2, w2, _ = fmap2.shape
    x0 = torch.floor(coords[..., 0])
    y0 = torch.floor(coords[..., 1])
    fx = coords[..., 0] - x0
    fy = coords[..., 1] - y0
    bidx = torch.arange(b, device=fmap1.device)[:, None, None]

    def corner(ix, iy, wgt):
        valid = (ix >= 0) & (ix <= w2 - 1) & (iy >= 0) & (iy <= h2 - 1)
        v = fmap2[bidx, iy.long().clamp(0, h2 - 1), ix.long().clamp(0, w2 - 1)]
        return (fmap1 * v).sum(dim=-1) * wgt * valid

    out = []
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            xb, yb = x0 + dx, y0 + dy
            out.append(corner(xb, yb, (1 - fx) * (1 - fy)) + corner(xb + 1, yb, fx * (1 - fy))
                       + corner(xb, yb + 1, (1 - fx) * fy) + corner(xb + 1, yb + 1, fx * fy))
    return torch.stack(out, dim=-1)


def windowed_correlation_tiled(fmap1: torch.Tensor, fmap2: torch.Tensor, coords: torch.Tensor,
                               radius: int, tile_bytes: int = TILE_BYTES) -> torch.Tensor:
    """:func:`windowed_correlation` by tiles of query rows: each tile's
    correlation rows against all of fmap2 as one batched matrix product,
    then its windows sampled from those rows.  A tile holds whole rows of
    the query image, as many as keep its correlation rows within
    ``tile_bytes`` (at least one)."""
    b, h, w, c = fmap1.shape
    _, h2, w2, _ = fmap2.shape
    n = 2 * radius + 1
    f1 = fmap1.reshape(b, h * w, c)
    f2t = fmap2.reshape(b, h2 * w2, c).transpose(1, 2)
    crd = coords.reshape(b, h * w, 2)
    rows = max(1, tile_bytes // (4 * b * w * h2 * w2))
    out = []
    for r0 in range(0, h, rows):
        s, e = r0 * w, min(h, r0 + rows) * w
        vol = torch.matmul(f1[:, s:e], f2t).reshape(b * (e - s), h2, w2)
        c = crd[:, s:e].reshape(-1, 2)
        out.append(window_sample(vol, c[:, 0], c[:, 1], radius).reshape(b, e - s, n * n))
    return torch.cat(out, dim=1).reshape(b, h, w, n * n)
