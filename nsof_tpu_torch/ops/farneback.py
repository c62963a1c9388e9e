"""Farnebäck parameters and the numpy-only coefficient helpers.

The PyTorch port's copy of the parts of :mod:`nsof_tpu.ops.farneback` that
the fast fused route needs: the parameter dataclass and presets, the
polynomial-expansion basis (OpenCV's FarnebackPrepareGaussian), the border
attenuation table, cvRound, cv2.getGaussianKernel and the pyramid-depth
clip.  None of it touches a tensor; the values are bit-identical to the JAX
package's (held by ``tests/test_torch_config.py``).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class FarnebackParams:
    """Mirror of the cv2 parameter dict (optical_flow_seg.py:73-81)."""

    pyr_scale: float = 0.5
    levels: int = 3
    winsize: int = 15
    iterations: int = 3
    poly_n: int = 5
    poly_sigma: float = 1.2


PRESETS = {
    "grasp": FarnebackParams(0.5, 3, 15, 3, 5, 1.2),
    "uavnew2": FarnebackParams(0.5, 3, 15, 3, 5, 1.2),
    "tabletennis": FarnebackParams(0.6, 3, 4, 2, 1, 1.05),
    "autodriving": FarnebackParams(0.6, 3, 3, 3, 10, 1.05),
    "uav": FarnebackParams(0.6, 3, 3, 3, 10, 1.05),
}


@functools.lru_cache(maxsize=None)
def _poly_exp_coeffs(n: int, sigma: float):
    """Gaussian basis kernels g, x·g, x²·g (Σg = 1) and the entries (1,1),
    (0,3), (3,3), (5,5) of the inverse 6×6 moment matrix for the basis
    (1, x, y, x², y², xy) — OpenCV's FarnebackPrepareGaussian."""
    if sigma < 1.19209290e-07:
        sigma = n * 0.3
    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    g /= g.sum()
    xg = x * g
    xxg = x * x * g

    m2 = float((g * x * x).sum())
    m4 = float((g * x**4).sum())
    moments = np.zeros((6, 6))
    moments[0, 0] = 1.0
    moments[1, 1] = moments[2, 2] = m2
    moments[0, 3] = moments[0, 4] = moments[3, 0] = moments[4, 0] = m2
    moments[3, 3] = moments[4, 4] = m4
    moments[3, 4] = moments[4, 3] = m2 * m2
    moments[5, 5] = m2 * m2
    inv = np.linalg.inv(moments)
    return (
        g.astype(np.float32),
        xg.astype(np.float32),
        xxg.astype(np.float32),
        float(inv[1, 1]),
        float(inv[0, 3]),
        float(inv[3, 3]),
        float(inv[5, 5]),
    )


# OpenCV's border[] attenuation table for the update matrices
_BORDER_TABLE = np.array([0.14, 0.14, 0.4472, 0.4472, 0.4472], np.float32)
_BORDER = 5


def _cv_round(v: float) -> int:
    """cvRound: round half to even (C rint)."""
    f = math.floor(v)
    diff = v - f
    if diff > 0.5:
        return f + 1
    if diff < 0.5:
        return f
    return f + (f % 2)


def _gaussian_blur_kernel(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel semantics, including the fixed small kernels
    when sigma <= 0."""
    if sigma <= 0:
        fixed = {
            1: [1.0],
            3: [0.25, 0.5, 0.25],
            5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
            7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375,
                0.03125],
        }
        if ksize in fixed:
            return np.asarray(fixed[ksize], np.float32)
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    k /= k.sum()
    return k.astype(np.float32)


def _effective_levels(h: int, w: int, levels: int, pyr_scale: float) -> int:
    """OpenCV clips pyramid depth so no level goes below 32 px."""
    min_size = 32
    k = 0
    scale = 1.0
    while k < levels:
        scale *= pyr_scale
        if w * scale < min_size or h * scale < min_size:
            break
        k += 1
    return k
