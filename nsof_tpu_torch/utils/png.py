"""PNG codec on the standard library (``zlib``, ``struct``) and numpy.

The port's image I/O: the serving and CLI paths read and write frames as
PNG through this module, so they need neither OpenCV nor Pillow (neither is
installed beside the port's GPU runtime).  It covers what those paths see:

- :func:`encode_png`: uint8 ``[H, W]`` (gray), ``[H, W, 3]`` (RGB) or
  ``[H, W, 4]`` (RGBA) → PNG bytes, every row with the Up filter.
- :func:`decode_png`: non-interlaced 8-bit gray, gray + alpha, RGB, RGBA
  and palette images, with all five row filters → uint8 ``[H, W, 3]`` RGB,
  or ``[H, W]`` gray with ``gray=True``.  Alpha is dropped and a gray image
  is replicated to three channels, as ``cv2.imdecode(..., IMREAD_COLOR)``
  does (in RGB order here); ``gray=True`` converts colour as
  ``cv2.IMREAD_GRAYSCALE`` does (libpng's ``png_set_rgb_to_gray`` with
  OpenCV's weights 0.299 and 0.587).  Anything else (JPEG or another
  format, 16-bit or sub-byte samples, Adam7 interlacing) raises
  ``ValueError`` naming what it found.
- :func:`encode_png16` / :func:`decode_png16`: 16-bit RGB images (uint16
  ``[H, W, 3]``), the samples big-endian as PNG stores them: KITTI's flow
  files.  The decoder also reads 16-bit RGBA, dropping alpha; other 16-bit
  images (gray, gray + alpha) raise ``ValueError``.  The channels come in
  RGB order, where ``cv2.imread(..., IMREAD_ANYDEPTH | IMREAD_COLOR)`` gives
  BGR.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type → samples a pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}
# libpng's fixed-point rgb → gray weights for OpenCV's (0.299, 0.587):
# floor(0.299 · 2¹⁵), floor(0.587 · 2¹⁵) and the rest of 2¹⁵
_GRAY_R, _GRAY_G, _GRAY_B = 9797, 19234, 3737


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _encode(rows: np.ndarray, w: int, h: int, depth: int, ctype: int, level: int) -> bytes:
    """PNG bytes of the raw scanlines ``rows`` ``[h, stride]`` (uint8),
    each with the Up filter."""
    up = rows.copy()
    up[1:] -= rows[:-1]  # uint8 arithmetic wraps mod 256, as the filter does
    raw = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level)) + _chunk(b"IEND", b""))


def encode_png(arr, level: int = 1) -> bytes:
    """uint8 ``[H, W]``, ``[H, W, 3]`` (RGB) or ``[H, W, 4]`` (RGBA) → PNG
    bytes (8-bit, non-interlaced, the Up filter on every row).  ``level`` is
    zlib's; the default, its fastest, is OpenCV's default for PNG too."""
    a = np.ascontiguousarray(np.asarray(arr))
    if a.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8, got {a.dtype}")
    if a.ndim == 2:
        a = a[..., None]
    if a.ndim != 3 or a.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"encode_png takes [H, W], [H, W, 3] or [H, W, 4], got {a.shape}")
    h, w, c = a.shape
    if h == 0 or w == 0:
        raise ValueError(f"encode_png needs a non-empty image, got {a.shape}")
    return _encode(a.reshape(h, w * c), w, h, 8, _COLOR_TYPE[c], level)


def encode_png16(arr, level: int = 1) -> bytes:
    """uint16 ``[H, W, 3]`` (RGB) → 16-bit PNG bytes (non-interlaced, the Up
    filter on every row's bytes)."""
    a = np.asarray(arr)
    if a.dtype != np.uint16 or a.ndim != 3 or a.shape[2] != 3:
        raise ValueError(f"encode_png16 takes uint16 [H, W, 3], got {a.dtype} {a.shape}")
    h, w, _ = a.shape
    if h == 0 or w == 0:
        raise ValueError(f"encode_png16 needs a non-empty image, got {a.shape}")
    rows = np.ascontiguousarray(a.astype(">u2")).view(np.uint8).reshape(h, w * 6)
    return _encode(rows, w, h, 16, 2, level)


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + n]
        if len(body) != n:
            raise ValueError("PNG data is truncated")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError("PNG data ends without an IEND chunk")


def _paeth_row(line: bytearray, prior: bytes, bpp: int) -> None:
    """Undo the Paeth filter in place: each byte predicted from its left,
    upper and upper-left neighbours, left to right.  The first pixel has
    no left neighbours, so its prediction is the byte above."""
    for i in range(bpp):
        line[i] = (line[i] + prior[i]) & 0xFF
    for i in range(bpp, len(line)):
        a, b, c = line[i - bpp], prior[i], prior[i - bpp]
        pa = abs(b - c)
        pb = abs(a - c)
        pc = abs(a + b - c - c)
        line[i] = (line[i] + (a if pa <= pb and pa <= pc else b if pb <= pc else c)) & 0xFF


def _average_row(line: bytearray, prior: bytes, bpp: int) -> None:
    """Undo the Average filter in place, left to right."""
    for i in range(bpp):
        line[i] = (line[i] + (prior[i] >> 1)) & 0xFF
    for i in range(bpp, len(line)):
        line[i] = (line[i] + ((line[i - bpp] + prior[i]) >> 1)) & 0xFF


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """The scanlines ``[h, stride]`` of decompressed ``raw``, each row's
    filter undone: None, Sub (a cumulative sum mod 256 per sample), Up (a
    sum with the row above) vectorised; Average and Paeth byte by byte."""
    if len(raw) < h * (stride + 1):
        raise ValueError("PNG image data is shorter than its header says")
    rows = np.frombuffer(raw, np.uint8, h * (stride + 1)).reshape(h, stride + 1)
    kinds, filt = rows[:, 0], rows[:, 1:]
    if kinds.max() > 4:
        raise ValueError(f"PNG row filter {int(kinds.max())} is not one of 0-4")
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind = kinds[y]
        if kind == 0:
            out[y] = filt[y]
        elif kind == 1:
            out[y] = np.cumsum(filt[y].reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:
            out[y] = filt[y] + prior
        else:
            line = bytearray(filt[y].tobytes())
            (_average_row if kind == 3 else _paeth_row)(line, prior.tobytes(), bpp)
            out[y] = np.frombuffer(line, np.uint8)
        prior = out[y]
    return out


def _to_gray(rgb: np.ndarray) -> np.ndarray:
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    # the weights sum to 2¹⁵, so a gray pixel (r = g = b) keeps its value
    return ((r * _GRAY_R + g * _GRAY_G + b * _GRAY_B) >> 15).astype(np.uint8)


def _read(data: bytes):
    """(header, palette, decompressed image data) of PNG bytes."""
    data = bytes(data)
    if not data.startswith(SIGNATURE):
        found = "JPEG" if data[:3] == b"\xff\xd8\xff" else "no PNG signature"
        raise ValueError(f"not a PNG image ({found}); send PNG images")
    header = None
    palette = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    ctype, interlace = header[3], header[6]
    if ctype not in _CHANNELS:
        raise ValueError(f"PNG colour type {ctype} is not one of 0, 2, 3, 4, 6")
    if interlace:
        raise ValueError("interlaced (Adam7) PNG is not supported; send a non-interlaced PNG")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"PNG image data is corrupt: {e}") from None
    return header, palette, raw


def decode_png(data: bytes, gray: bool = False) -> np.ndarray:
    """PNG bytes → uint8 ``[H, W, 3]`` RGB, or ``[H, W]`` with ``gray``
    (see the module docstring for what is read and what raises)."""
    (w, h, depth, ctype, _, _, _), palette, raw = _read(data)
    if depth != 8:
        raise ValueError(f"{depth}-bit PNG samples are not supported; send 8-bit PNG")
    c = _CHANNELS[ctype]
    px = _unfilter(raw, h, w * c, c).reshape(h, w, c)
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG has no PLTE chunk")
        if px.max() >= len(palette):
            raise ValueError("palette PNG indexes past its PLTE chunk")
        rgb = palette[px[..., 0]]
    elif ctype in (0, 4):
        return px[..., 0].copy() if gray else np.repeat(px[..., :1], 3, axis=-1)
    else:
        rgb = px[..., :3]
    return _to_gray(rgb) if gray else np.ascontiguousarray(rgb)


def decode_png16(data: bytes) -> np.ndarray:
    """16-bit RGB or RGBA PNG bytes → uint16 ``[H, W, 3]`` RGB (alpha
    dropped); anything else raises ``ValueError``."""
    (w, h, depth, ctype, _, _, _), _, raw = _read(data)
    if depth != 16 or ctype not in (2, 6):
        raise ValueError(f"decode_png16 reads 16-bit RGB or RGBA PNG, got {depth}-bit "
                         f"colour type {ctype}")
    c = _CHANNELS[ctype]
    px = _unfilter(raw, h, w * c * 2, c * 2).view(">u2").reshape(h, w, c)
    return px[..., :3].astype(np.uint16)
