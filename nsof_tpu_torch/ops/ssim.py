"""Structural similarity (SSIM) with scikit-image's defaults, batched.

Counterpart of :mod:`nsof_tpu.ops.ssim`: a 7×7 uniform filter, K1 = 0.01,
K2 = 0.03, the sample-covariance factor N/(N−1), the mean taken over the
map cropped by (win_size−1)//2 on every side.  The moments are filtered
about each image's mean (exact to float32 rounding on 0..255 data) and the
filter is a sum of shifted slices, not a convolution, so no TF32 enters on
the card.
"""

from __future__ import annotations

import numpy as np
import torch

from nsof_tpu_torch.ops.farneback import _extend, _tap_sum


def _uniform_filter(x: torch.Tensor, size: int) -> torch.Tensor:
    """Mean over size × size windows of ``[B, H, W]`` with edge padding
    (the padded band is cropped before the mean, so its values do not
    matter)."""
    r = size // 2
    h, w = x.shape[-2:]
    ones = np.ones(size, np.float32)
    xp = _extend(x, r, r, r, r)
    return _tap_sum(_tap_sum(xp, ones, -2, h), ones, -1, w) * (1.0 / (size * size))


def ssim(im1: torch.Tensor, im2: torch.Tensor, data_range: float = 255.0,
         win_size: int = 7, k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Mean SSIM of single-channel images ``[B, H, W]`` → ``[B]`` float32
    (``[H, W]`` pairs → a scalar)."""
    x = im1.float()
    y = im2.float()
    squeeze = x.ndim == 2
    if squeeze:
        x, y = x[None], y[None]
    npix = win_size * win_size
    cov_norm = npix / (npix - 1.0)
    mx = x.mean(dim=(-2, -1), keepdim=True)
    my = y.mean(dim=(-2, -1), keepdim=True)
    xc = x - mx
    yc = y - my
    uxc = _uniform_filter(xc, win_size)
    uyc = _uniform_filter(yc, win_size)
    ux = uxc + mx
    uy = uyc + my
    vx = cov_norm * (_uniform_filter(xc * xc, win_size) - uxc * uxc)
    vy = cov_norm * (_uniform_filter(yc * yc, win_size) - uyc * uyc)
    vxy = cov_norm * (_uniform_filter(xc * yc, win_size) - uxc * uyc)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    s = ((2.0 * ux * uy + c1) * (2.0 * vxy + c2)) / (
        (ux * ux + uy * uy + c1) * (vx + vy + c2))
    pad = (win_size - 1) // 2
    out = s[..., pad:-pad, pad:-pad].mean(dim=(-2, -1))
    return out[0] if squeeze else out
