"""Optical-flow color coding (Middlebury / Baker et al. color wheel): the
port's counterpart of :mod:`nsof_tpu.utils.flow_viz`.

The standard flow visualisation the reference vendors as ``flow_viz.py``
(make_colorwheel :20-67, flow_uv_to_colors :70-106, flow_to_image
:109-135): a 55-color wheel over six hue transitions (RY=15, YG=6, GC=4,
CB=11, BM=13, MR=6), flow normalised by the maximum radius, angle → wheel
position, saturation scaled by radius.  :func:`flow_to_image` runs the JAX
function's operations in its order, each rounded once (square roots and
divisions as :mod:`nsof_tpu_torch.ops.colorspace` takes them); only
``atan2`` may differ from XLA's by one float32 ulp.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from nsof_tpu_torch.device.model import _div
from nsof_tpu_torch.ops.colorspace import magnitude


@functools.lru_cache(maxsize=1)
def make_colorwheel() -> np.ndarray:
    """[55, 3] uint8-valued float color wheel (RGB)."""
    transitions = [("RY", 15), ("YG", 6), ("GC", 4), ("CB", 11), ("BM", 13),
                   ("MR", 6)]
    ncols = sum(n for _, n in transitions)
    wheel = np.zeros((ncols, 3))
    col = 0
    for name, n in transitions:
        ramp = np.arange(n) / n
        if name == "RY":
            wheel[col : col + n, 0] = 255
            wheel[col : col + n, 1] = np.floor(255 * ramp)
        elif name == "YG":
            wheel[col : col + n, 0] = 255 - np.floor(255 * ramp)
            wheel[col : col + n, 1] = 255
        elif name == "GC":
            wheel[col : col + n, 1] = 255
            wheel[col : col + n, 2] = np.floor(255 * ramp)
        elif name == "CB":
            wheel[col : col + n, 1] = 255 - np.floor(255 * ramp)
            wheel[col : col + n, 2] = 255
        elif name == "BM":
            wheel[col : col + n, 2] = 255
            wheel[col : col + n, 0] = np.floor(255 * ramp)
        else:  # MR
            wheel[col : col + n, 2] = 255 - np.floor(255 * ramp)
            wheel[col : col + n, 0] = 255
        col += n
    return wheel


def flow_to_image(flow_uv, clip_flow: float | None = None,
                  convert_to_bgr: bool = False) -> torch.Tensor:
    """Flow ``[H, W, 2]`` (a tensor, on its device) → uint8 color image
    ``[H, W, 3]``.

    Radius-normalises by the max magnitude then colors by angle; unsaturated
    outside the unit radius (factor 0.75 on overshoot), matching the
    Middlebury convention used by the reference's ``flow_to_image``.
    """
    flow_uv = torch.as_tensor(flow_uv)
    u = flow_uv[..., 0].to(torch.float32)
    v = flow_uv[..., 1].to(torch.float32)
    if clip_flow is not None:
        u = u.clamp(0, clip_flow)
        v = v.clamp(0, clip_flow)
    rad_max = magnitude(u, v).max().clamp(min=1e-5)
    u = u / rad_max
    v = v / rad_max

    # each entry / 255 rounded once, as the JAX function divides the gathers
    wheel = torch.from_numpy(make_colorwheel().astype(np.float32) / np.float32(255.0))
    wheel = wheel.to(u.device)
    ncols = wheel.shape[0]
    rad = magnitude(u, v)
    a = _div(torch.atan2(-v, -u), math.pi)
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = torch.floor(fk).to(torch.int32)
    k1 = (k0 + 1) % ncols
    f = fk - k0

    cols = []
    for ch in range(3):
        col0 = wheel[k0.long(), ch]
        col1 = wheel[k1.long(), ch]
        col = (1 - f) * col0 + f * col1
        col = torch.where(rad <= 1, 1 - rad * (1 - col), col * 0.75)
        cols.append(torch.floor(255.0 * col))
    # channel order: RGB, or BGR on request (reference default writes BGR)
    img = torch.stack(cols, dim=-1)
    if convert_to_bgr:
        img = img.flip(-1)
    return img.to(torch.uint8)
