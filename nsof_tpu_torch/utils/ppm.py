"""Binary PPM (P6) reader and writer on numpy: FlyingChairs' frames.

:func:`decode_ppm` reads 8-bit P6 images (maxval ≤ 255, ``#`` comments in
the header) → uint8 ``[H, W, 3]`` RGB, as ``cv2.imread`` reads them (in
RGB order here, where OpenCV gives BGR).  Any other Netpbm kind, a maxval
above 255 or truncated pixel data raise ``ValueError``.
"""

from __future__ import annotations

import re

import numpy as np

_TOKEN = re.compile(rb"(?:\s|#[^\n]*\n?)*(\S+)")


def decode_ppm(data: bytes) -> np.ndarray:
    data = bytes(data)
    if not data.startswith(b"P6"):
        raise ValueError(f"not a binary PPM (P6) image: starts with {data[:2]!r}")
    pos, fields = 2, []
    for _ in range(3):
        m = _TOKEN.match(data, pos)
        if m is None or not m.group(1).isdigit():
            raise ValueError("PPM header is malformed")
        fields.append(int(m.group(1)))
        pos = m.end()
    w, h, maxval = fields
    if not 0 < maxval <= 255:
        raise ValueError(f"PPM maxval {maxval} is not 1-255: only 8-bit PPM is supported")
    pos += 1  # the single whitespace byte after maxval
    n = w * h * 3
    if len(data) - pos < n:
        raise ValueError("PPM pixel data is shorter than its header says")
    return np.frombuffer(data, np.uint8, n, pos).reshape(h, w, 3).copy()


def encode_ppm(rgb) -> bytes:
    """uint8 ``[H, W, 3]`` RGB → P6 bytes (maxval 255)."""
    a = np.ascontiguousarray(np.asarray(rgb))
    if a.dtype != np.uint8 or a.ndim != 3 or a.shape[2] != 3:
        raise ValueError(f"encode_ppm takes uint8 [H, W, 3], got {a.dtype} {a.shape}")
    return b"P6\n%d %d\n255\n" % (a.shape[1], a.shape[0]) + a.tobytes()
