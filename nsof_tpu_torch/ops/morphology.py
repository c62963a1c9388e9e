"""Binary and grayscale morphology with OpenCV's structuring elements,
anchors and borders.

Counterpart of :mod:`nsof_tpu.ops.morphology` on tensors ``[..., H, W]``.
The JAX package counts SE hits with a float convolution; here every op is
an OR, AND, max or min over shifted slices, so the results are exact on
any device and equal the JAX results bit for bit (a convolution on the card
could run in TF32, FFT or Winograd form, where the hit counts would no
longer be exact).  The anchor is ``(kh//2, kw//2)`` for every SE, even-sized
ones included.  Borders follow OpenCV's ``morphologyDefaultBorderValue``:
nothing dilates in from outside the image and nothing erodes in.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from nsof_tpu_torch.ops.morphology_fast import _or_over_se


@functools.lru_cache(maxsize=None)
def ellipse_se(rows: int, cols: int) -> np.ndarray:
    """``cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (cols, rows))``.

    OpenCV fills, per row i, the span ``[c - dx, c + dx]`` where
    ``dx = c * sqrt(r² - dy²) / r`` with integer rounding, anchor
    ``(r, c) = (rows//2, cols//2)``.
    """
    r, c = rows // 2, cols // 2
    inv_r2 = 1.0 / (r * r) if r > 0 else 0.0
    se = np.zeros((rows, cols), np.uint8)
    for i in range(rows):
        dy = i - r
        if abs(dy) <= r:
            dx = int(round(c * np.sqrt(max(r * r - dy * dy, 0) * inv_r2)))
            se[i, max(c - dx, 0) : min(c + dx + 1, cols)] = 1
        # rows below 2r+1 in an even-sized kernel stay empty, as in OpenCV
    return se


def _u8(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.uint8) * 255


def dilate_binary(mask: torch.Tensor, se: np.ndarray) -> torch.Tensor:
    """``cv2.dilate`` of a {0, 255} uint8 mask: 255 where any SE offset
    hits the foreground; outside the image counts as background."""
    return _u8(_or_over_se(mask > 0, se))


def erode_binary(mask: torch.Tensor, se: np.ndarray) -> torch.Tensor:
    """``cv2.erode`` of a {0, 255} uint8 mask: 255 where every SE offset
    hits the foreground; outside the image counts as foreground."""
    return _u8(~_or_over_se(mask <= 0, se))


def morph_close(mask: torch.Tensor, se: np.ndarray) -> torch.Tensor:
    """``cv2.morphologyEx(mask, cv2.MORPH_CLOSE, se)``: dilate, then erode."""
    return erode_binary(dilate_binary(mask, se), se)


def _gray_reduce(img: torch.Tensor, se: np.ndarray, op, pad_value: int):
    """Max or min of ``img`` over the SE's offsets, the border filled with
    ``pad_value`` (0 for the max, 255 for the min)."""
    kh, kw = se.shape
    ay, ax = kh // 2, kw // 2
    h, w = img.shape[-2:]
    xp = F.pad(img, (ax, kw - 1 - ax, ay, kh - 1 - ay), value=pad_value)
    out = None
    for dy, dx in zip(*np.nonzero(se)):
        piece = xp[..., dy : dy + h, dx : dx + w]
        out = piece if out is None else op(out, piece)
    return out


def dilate_gray(img: torch.Tensor, se: np.ndarray) -> torch.Tensor:
    """``cv2.dilate`` of a grayscale uint8 image (max filter)."""
    return _gray_reduce(img, se, torch.maximum, 0)


def erode_gray(img: torch.Tensor, se: np.ndarray) -> torch.Tensor:
    """``cv2.erode`` of a grayscale uint8 image (min filter)."""
    return _gray_reduce(img, se, torch.minimum, 255)


def morph_close_gray(img: torch.Tensor, se: np.ndarray) -> torch.Tensor:
    """Grayscale MORPH_CLOSE: dilate, then erode."""
    return erode_gray(dilate_gray(img, se), se)


def dilate_erode_n(mask: torch.Tensor, se: np.ndarray, iterations: int):
    """The seg head's smoothing loop, N × (dilate; erode) = N × close."""
    for _ in range(iterations):
        mask = morph_close(mask, se)
    return mask
