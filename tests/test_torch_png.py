"""The port's PNG codec (``nsof_tpu_torch/utils/png.py``) against OpenCV's.

The port reads and writes its images through its own codec, since OpenCV
is not installed beside its GPU runtime; here OpenCV is the reference:

- the port's encoder against ``cv2.imdecode`` and ``cv2.imencode`` against
  the port's decoder, on gray, RGB and RGBA images made with numpy from a
  seed, colour and gray decodes, exact;
- palette and gray + alpha PNGs, and hand-built PNGs whose rows use each of
  the five filter types (None, Sub, Up, Average, Paeth), against
  ``cv2.imdecode``, exact;
- JPEG bytes, 16-bit, interlaced and truncated PNGs raise ``ValueError``
  naming what they are;
- a 640×480 RGB image whose every row is Paeth-filtered (the slowest row
  filter, undone byte by byte) decodes in well under 2 s.
"""

import struct
import time
import zlib

import numpy as np
import pytest

from nsof_tpu_torch.utils.png import SIGNATURE, decode_png, encode_png

cv2 = pytest.importorskip("cv2")

RNG = np.random.default_rng(0)
SHAPES = [(1, 1), (37, 53), (64, 96)]


def _image(shape, channels, smooth=False):
    h, w = shape
    if smooth:
        yy, xx = np.mgrid[0:h, 0:w]
        base = (xx * 3 + yy * 2) % 256
        img = np.stack([(base + 40 * c) % 256 for c in range(max(channels, 1))], -1)
        img = (img + RNG.integers(-6, 7, img.shape)).clip(0, 255).astype(np.uint8)
    else:
        img = RNG.integers(0, 256, (h, w, max(channels, 1)), dtype=np.uint8)
    return img[..., 0] if channels == 0 else img


def _cv_decode(data: bytes, flag) -> np.ndarray:
    return cv2.imdecode(np.frombuffer(data, np.uint8), flag)


def _rgb_from_cv(bgr: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(bgr[..., ::-1])


def _png(width, height, ctype, rows, kinds, extra=b"", depth=8, interlace=0):
    """A PNG from raw filtered scanlines ``rows`` ``[h, stride]`` and
    their filter bytes ``kinds``."""
    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))
    raw = np.concatenate([np.asarray(kinds, np.uint8)[:, None], rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", width, height, depth, ctype, 0, 0, interlace)
    return (SIGNATURE + chunk(b"IHDR", ihdr) + extra
            + chunk(b"IDAT", zlib.compress(raw.tobytes())) + chunk(b"IEND", b""))


def _filter_rows(img: np.ndarray, kinds) -> np.ndarray:
    """Filter ``img``'s scanlines with the PNG row filters ``kinds``, by
    the specification's per-byte definitions."""
    h = img.shape[0]
    bpp = img.shape[2] if img.ndim == 3 else 1
    lines = img.reshape(h, -1).astype(np.int64)
    out = np.empty_like(lines)
    for y in range(h):
        prior = lines[y - 1] if y else np.zeros_like(lines[0])
        for i in range(lines.shape[1]):
            a = lines[y, i - bpp] if i >= bpp else 0
            b = prior[i]
            c = prior[i - bpp] if i >= bpp else 0
            kind = kinds[y]
            if kind == 0:
                pred = 0
            elif kind == 1:
                pred = a
            elif kind == 2:
                pred = b
            elif kind == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out[y, i] = (lines[y, i] - pred) % 256
    return out.astype(np.uint8)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("channels", [0, 3, 4])
def test_encoder_against_cv2_decoder(shape, channels):
    img = _image(shape, channels, smooth=shape[0] > 1)
    data = encode_png(img)
    got = _cv_decode(data, cv2.IMREAD_UNCHANGED)
    if channels == 3:
        got = _rgb_from_cv(got)
    elif channels == 4:
        got = np.ascontiguousarray(got[..., [2, 1, 0, 3]])
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("channels", [0, 3, 4])
def test_cv2_encoder_against_decoder(shape, channels):
    """OpenCV's PNG against the port's colour and gray decodes: colour
    drops alpha and replicates gray, gray converts as IMREAD_GRAYSCALE."""
    img = _image(shape, channels, smooth=shape[0] > 1)
    ok, buf = cv2.imencode(".png", img)
    assert ok
    data = buf.tobytes()
    np.testing.assert_array_equal(decode_png(data),
                                  _rgb_from_cv(_cv_decode(data, cv2.IMREAD_COLOR)))
    np.testing.assert_array_equal(decode_png(data, gray=True),
                                  _cv_decode(data, cv2.IMREAD_GRAYSCALE))
    if channels == 3:
        np.testing.assert_array_equal(decode_png(data), _rgb_from_cv(img))


def test_palette_and_gray_alpha_against_cv2():
    h, w = 23, 31
    palette = RNG.integers(0, 256, (7, 3), dtype=np.uint8)
    idx = RNG.integers(0, 7, (h, w), dtype=np.uint8)
    ga = RNG.integers(0, 256, (h, w, 2), dtype=np.uint8)
    plte = struct.pack(">I", palette.size) + b"PLTE" + palette.tobytes()
    plte += struct.pack(">I", zlib.crc32(b"PLTE" + palette.tobytes()) & 0xFFFFFFFF)
    cases = {
        "palette": _png(w, h, 3, _filter_rows(idx, [1] * h), [1] * h, extra=plte),
        "gray_alpha": _png(w, h, 4, _filter_rows(ga, [4] * h), [4] * h),
    }
    for name, data in cases.items():
        np.testing.assert_array_equal(decode_png(data),
                                      _rgb_from_cv(_cv_decode(data, cv2.IMREAD_COLOR)), name)
        np.testing.assert_array_equal(decode_png(data, gray=True),
                                      _cv_decode(data, cv2.IMREAD_GRAYSCALE), name)
    np.testing.assert_array_equal(decode_png(cases["palette"]), palette[idx])
    np.testing.assert_array_equal(decode_png(cases["gray_alpha"], gray=True), ga[..., 0])


@pytest.mark.parametrize("channels", [0, 3, 4])
def test_every_row_filter(channels):
    """Rows filtered with None, Sub, Up, Average and Paeth in turn (each
    also as the first row, whose prior row is zero)."""
    h, w = 15, 19
    img = _image((h, w), channels)
    for first in range(5):
        kinds = [(first + y) % 5 for y in range(h)]
        data = _png(w, h, {0: 0, 3: 2, 4: 6}[channels], _filter_rows(img, kinds), kinds)
        ref = _cv_decode(data, cv2.IMREAD_UNCHANGED)
        if channels == 3:
            ref = _rgb_from_cv(ref)
        elif channels == 4:
            ref = ref[..., [2, 1, 0, 3]]
        np.testing.assert_array_equal(ref, img)
        if channels == 4:
            np.testing.assert_array_equal(decode_png(data), img[..., :3])
        else:
            np.testing.assert_array_equal(decode_png(data, gray=channels == 0), img)


def test_rejects_what_it_cannot_read():
    img = _image((16, 16), 3)
    ok, jpeg = cv2.imencode(".jpg", img)
    assert ok
    with pytest.raises(ValueError, match="JPEG.*PNG"):
        decode_png(jpeg.tobytes())
    rows = np.zeros((4, 8), np.uint8)
    with pytest.raises(ValueError, match="16-bit"):
        decode_png(_png(4, 4, 0, rows, [0] * 4, depth=16))
    with pytest.raises(ValueError, match="interlaced"):
        decode_png(_png(8, 4, 0, rows, [0] * 4, interlace=1))
    with pytest.raises(ValueError, match="truncated|IEND"):
        decode_png(encode_png(img)[:-30])
    with pytest.raises(ValueError):
        encode_png(np.zeros((4, 4, 2), np.uint8))


def test_paeth_rgb_640x480_decodes_fast():
    h, w = 480, 640
    filt = RNG.integers(0, 256, (h, w * 3), dtype=np.uint8)
    data = _png(w, h, 2, filt, [4] * h)
    start = time.perf_counter()
    got = decode_png(data)
    seconds = time.perf_counter() - start
    assert got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, _rgb_from_cv(_cv_decode(data, cv2.IMREAD_COLOR)))
    assert seconds < 1.5, seconds
