"""Bilinear remap and flow warping (``cv2.remap``), batched over B.

Counterpart of :mod:`nsof_tpu.ops.warp`: the prediction head warps the
next frame by ``grid + flow`` with INTER_LINEAR and BORDER_REPLICATE
(optical_flow_prediction.py:281-300), here as four clamped gathers and the
bilinear weights in the JAX source's order.
"""

from __future__ import annotations

import torch


def remap_bilinear(img: torch.Tensor, map_x: torch.Tensor,
                   map_y: torch.Tensor) -> torch.Tensor:
    """Sample ``img`` ``[B, H, W]`` or ``[B, H, W, C]`` at ``(map_x,
    map_y)`` ``[B, h, w]`` (x = column, y = row) with bilinear weights and
    replicated borders → ``[B, h, w(, C)]`` in img's dtype; an integer
    image is rounded half to even and clamped to [0, 255].

    Matches ``cv2.remap(..., cv2.INTER_LINEAR, borderMode=
    cv2.BORDER_REPLICATE)`` up to OpenCV's 5-bit fixed-point fractions."""
    squeeze = img.ndim == 3
    if squeeze:
        img = img[..., None]
    b, h, w, c = img.shape
    x = map_x.float()
    y = map_y.float()
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i, x1i = x0.long().clamp(0, w - 1), (x0 + 1).long().clamp(0, w - 1)
    y0i, y1i = y0.long().clamp(0, h - 1), (y0 + 1).long().clamp(0, h - 1)
    flat = img.float().reshape(b, h * w, c)
    out_hw = x.shape[1:]

    def tap(yi, xi):
        idx = (yi * w + xi).reshape(b, -1, 1).expand(-1, -1, c)
        return flat.gather(1, idx).reshape(b, *out_hw, c)

    out = (tap(y0i, x0i) * (1 - fx) * (1 - fy)
           + tap(y0i, x1i) * fx * (1 - fy)
           + tap(y1i, x0i) * (1 - fx) * fy
           + tap(y1i, x1i) * fx * fy)
    if img.dtype.is_floating_point:
        out = out.to(img.dtype)
    else:
        out = torch.round(out).clamp(0, 255).to(img.dtype)
    return out[..., 0] if squeeze else out


def warp_by_flow(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp ``img`` by sampling at ``grid + flow`` (``flow`` ``[B, h, w,
    2]``, the prediction head's ``flow_map``)."""
    h, w = flow.shape[1:3]
    xs = torch.arange(w, dtype=torch.float32, device=flow.device) + flow[..., 0]
    ys = torch.arange(h, dtype=torch.float32, device=flow.device)[:, None] + flow[..., 1]
    return remap_bilinear(img, xs, ys)
