"""Structuring elements for the binary morphology of the task heads."""

from __future__ import annotations

import functools

import numpy as np


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
