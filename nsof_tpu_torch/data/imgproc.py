"""numpy versions of the OpenCV calls the training data layer makes.

The JAX package's augmentation and synthetic data call OpenCV
(``nsof_tpu/data/flow_datasets.py``); the port's data layer runs where
OpenCV is not installed, so it computes the same functions here, following
OpenCV's own arithmetic:

- :func:`resize_linear` is ``cv2.resize(..., INTER_LINEAR)``: half-pixel
  centres, the edge pixel repeated, no antialiasing when shrinking.  uint8
  images take OpenCV's 11-bit fixed-point weights and its vectorised row
  blend; float32 images its float weights.
- :func:`resize_cubic` is ``cv2.resize(uint8, INTER_CUBIC)`` of gray or RGB
  as OpenCV 5 computes it: Keys' cubic with a = −0.75, each output's four
  tap distances in float32 from its first (``t0 = frac + 1``, ``t0 − 1``,
  ``2 − t0``, ``3 − t0``) and their weights in double rounded to float32,
  the edge pixel repeated; float32 sums of products, as its code contracts
  them into fused multiply-adds: along x in pairs (gray) or in order, each
  product added in one rounding (RGB), along y two fused pairs added;
  rounded to nearest even and saturated.  OpenCV 4's 11-bit fixed point
  differs from it on ≈ 5 % of values.
- :func:`rgb_to_hsv_u8` is ``cv2.cvtColor(..., COLOR_RGB2HSV)`` on uint8
  (H in [0, 180)), OpenCV's 12-bit integer tables; :func:`hsv_to_rgb_u8` is
  ``COLOR_HSV2RGB``, OpenCV's float sector formula, truncated where its
  vectorised loop truncates.
- :func:`gaussian_blur` is ``cv2.GaussianBlur(img, (0, 0), sigma)`` on
  float32: ``round(8σ + 1) | 1`` taps (17 at σ = 2) with reflect-101
  borders, rows then columns.
- :func:`warp_translate` is ``cv2.warpAffine`` of a translation on float32,
  bilinear, as OpenCV 5 computes it (float32 coordinates, no 1/32 px
  rounding of the fraction as in OpenCV 4).

Where OpenCV's vectorised code rounds or fuses differently from its scalar
code, results can differ by one uint8 level or float32 rounding; the tests
measure it (``tests/test_torch_train_data.py``).
"""

from __future__ import annotations

import numpy as np

_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS
_HSV_SHIFT = 12


def _linear_taps(n_in: int, n_out: int, clamp: bool):
    """OpenCV's per-output source indices and float32 fraction along one
    axis (``resizeGeneric``'s coefficient loops).  Along x (``clamp``) an
    index past either edge takes the edge pixel with weight 0; along y the
    fraction stays and the two row indices are clipped, so an edge row
    blends with itself."""
    scale = 1.0 / (n_out / n_in)
    f = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    i = np.floor(f).astype(np.int64)
    f = f - i.astype(np.float32)
    if clamp:
        low = i < 0
        f[low], i[low] = 0, 0
        high = i >= n_in - 1
        f[high], i[high] = 0, n_in - 1
    return np.clip(i, 0, n_in - 1), np.clip(i + 1, 0, n_in - 1), f


def linear_taps_u8(n_in: int, n_out: int, clamp: bool):
    """:func:`_linear_taps` with the fraction as OpenCV's two 11-bit
    fixed-point weights of a uint8 resize: ``(i0, i1, a0, a1)``, int32."""
    i0, i1, f = _linear_taps(n_in, n_out, clamp)
    a0 = np.rint((np.float32(1) - f) * _COEF_SCALE).astype(np.int32)
    return i0, i1, a0, np.rint(f * _COEF_SCALE).astype(np.int32)


def resize_linear(img: np.ndarray, nw: int, nh: int) -> np.ndarray:
    """``cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)`` for
    uint8 or float32 ``[H, W]`` / ``[H, W, C]``."""
    h, w = img.shape[:2]
    if img.dtype == np.uint8:
        x0, x1, ax0, ax1 = linear_taps_u8(w, nw, clamp=True)
        y0, y1, by0, by1 = linear_taps_u8(h, nh, clamp=False)
        src = img.astype(np.int32)
        shape = (1, nw) + (1,) * (img.ndim - 2)
        rows = src[:, x0] * ax0.reshape(shape) + src[:, x1] * ax1.reshape(shape)
        s0, s1 = rows[y0] >> 4, rows[y1] >> 4
        col = (nh, 1) + (1,) * (img.ndim - 2)
        # the vectorised row blend: 16-bit high products, then (x + 2) >> 2
        v = ((s0 * by0.reshape(col)) >> 16) + ((s1 * by1.reshape(col)) >> 16)
        return np.clip((v + 2) >> 2, 0, 255).astype(np.uint8)
    if img.dtype != np.float32:
        raise ValueError(f"resize_linear takes uint8 or float32, got {img.dtype}")
    x0, x1, fx = _linear_taps(w, nw, clamp=True)
    y0, y1, fy = _linear_taps(h, nh, clamp=False)
    shape = (1, nw) + (1,) * (img.ndim - 2)
    ax1 = fx.reshape(shape)
    ax0 = np.float32(1) - ax1
    rows = img[:, x0] * ax0 + img[:, x1] * ax1
    col = (nh, 1) + (1,) * (img.ndim - 2)
    by1 = fy.reshape(col)
    by0 = np.float32(1) - by1
    return rows[y0] * by0 + rows[y1] * by1


def _cubic_taps(n_in: int, n_out: int):
    """OpenCV 5's per-output source indices (the edge repeated) and float32
    weights of the four cubic taps along one axis."""
    a = -0.75
    f = (np.arange(n_out) + 0.5) * (1.0 / (n_out / n_in)) - 0.5
    s = np.floor(f).astype(np.int64)
    t0 = (f - s).astype(np.float32) + np.float32(1)
    t = [t0, t0 - np.float32(1), np.float32(2) - t0, np.float32(3) - t0]
    near = lambda x: ((a + 2) * x - (a + 3)) * x * x + 1  # noqa: E731
    far = lambda x: ((a * x - 5 * a) * x + 8 * a) * x - 4 * a  # noqa: E731
    w = np.stack([far(t[0].astype(np.float64)), near(t[1].astype(np.float64)),
                  near(t[2].astype(np.float64)), far(t[3].astype(np.float64))], axis=-1)
    idx = np.clip(s[:, None] + np.arange(-1, 3)[None, :], 0, n_in - 1)
    return idx, w.astype(np.float32)


def _fma(a, b, c):
    """float32 ``a · b + c`` rounded once (the product of two float32 values
    is exact in float64)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def resize_cubic(img: np.ndarray, nw: int, nh: int) -> np.ndarray:
    """``cv2.resize(img, (nw, nh), interpolation=cv2.INTER_CUBIC)`` for
    uint8 ``[H, W]`` / ``[H, W, 3]`` (OpenCV 5's arithmetic: see the module
    docstring, and ``tests/test_torch_gt_tooling.py`` for how close)."""
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"resize_cubic takes uint8 [H, W] or [H, W, 3], got {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape[:2]
    xi, xw = _cubic_taps(w, nw)
    yi, yw = _cubic_taps(h, nh)
    extra = (1,) * (img.ndim - 2)
    src = img.astype(np.float32)
    v = [src[:, xi[:, k]] for k in range(4)]
    a = [xw[:, k].reshape((1, nw) + extra) for k in range(4)]
    if img.ndim == 2:  # the taps in pairs
        rows = (v[0] * a[0] + v[1] * a[1]) + (v[2] * a[2] + v[3] * a[3])
    else:  # in order, each product added in one rounding
        rows = v[0] * a[0]
        for k in range(1, 4):
            rows = _fma(v[k], a[k], rows)
    r = [rows[yi[:, k]] for k in range(4)]
    b = [yw[:, k].reshape((nh, 1) + extra) for k in range(4)]
    out = _fma(r[0], b[0], r[1] * b[1]) + _fma(r[2], b[2], r[3] * b[3])
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _hsv_tables():
    i = np.arange(1, 256, dtype=np.float64)
    sdiv = np.zeros(256, np.int32)
    hdiv = np.zeros(256, np.int32)
    sdiv[1:] = np.rint((255 << _HSV_SHIFT) / i)
    hdiv[1:] = np.rint((180 << _HSV_SHIFT) / (6.0 * i))
    return sdiv, hdiv


_SDIV, _HDIV = _hsv_tables()


def rgb_to_hsv_u8(rgb: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV)`` for uint8 ``[..., 3]``."""
    v = rgb.max(axis=-1)
    diff = (v - rgb.min(axis=-1)).astype(np.int32)
    r, g, b = (rgb[..., k].astype(np.int32) for k in range(3))
    half = 1 << (_HSV_SHIFT - 1)
    out = np.empty(rgb.shape, np.uint8)
    out[..., 1] = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    out[..., 2] = v
    vi = v.astype(np.int32)
    h = np.where(vi == r, g - b, np.where(vi == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + half) >> _HSV_SHIFT
    h[h < 0] += 180
    out[..., 0] = h
    return out


# pixels a block of OpenCV's vectorised HSV → RGB loop (eight float32 lanes,
# four vectors: AVX2); the rest of a row takes its scalar loop
_HSV_BLOCK = 32
# for each sector, which of (v, p, q, t) is r, g and b (OpenCV's sector_data)
_SECTOR_RGB = ((0, 3, 1), (2, 0, 1), (1, 0, 3), (1, 2, 0), (3, 1, 0), (0, 1, 2))


def hsv_to_rgb_u8(hsv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)`` for uint8 ``[H, W, 3]``:
    OpenCV's vectorised loop truncates each channel's ``255·x`` for the
    first ``W // 32 · 32`` pixels of a row, its scalar loop rounds half to
    even for the rest."""
    f32 = np.float32
    h = hsv[..., 0].astype(f32) * f32(6.0 / 180.0)
    s = hsv[..., 1].astype(f32) * f32(1.0 / 255.0)
    v = hsv[..., 2].astype(f32) * f32(1.0 / 255.0)
    h = np.fmod(h, f32(6))
    sector = np.floor(h)
    h -= sector
    sector = sector.astype(np.int8)
    bad = (sector < 0) | (sector >= 6)
    sector[bad], h[bad] = 0, 0
    one = f32(1)
    tab = (v, v * (one - s), v * (one - s * h), v * (one - s * (one - h)))
    out = np.empty(hsv.shape, f32)
    for c in range(3):
        out[..., c] = np.choose(sector, [tab[_SECTOR_RGB[k][c]] for k in range(6)])
    grey = s == 0
    out[grey] = v[grey][:, None]
    out *= f32(255)
    body = hsv.shape[-2] // _HSV_BLOCK * _HSV_BLOCK
    np.trunc(out[..., :body, :], out=out[..., :body, :])
    np.rint(out[..., body:, :], out=out[..., body:, :])
    return np.clip(out, 0, 255).astype(np.uint8)


def _gaussian_kernel(sigma: float) -> np.ndarray:
    """OpenCV's float32 Gaussian of ``round(8σ + 1) | 1`` taps, summed in
    float64 and normalised once."""
    n = int(np.rint(sigma * 4 * 2 + 1)) | 1
    x = np.arange(n) - (n - 1) * 0.5
    t = np.exp(-0.5 / (sigma * sigma) * x * x)
    return (t / t.sum()).astype(np.float32)


def _filter_axis(x: np.ndarray, k: np.ndarray, axis: int) -> np.ndarray:
    r = len(k) // 2
    pad = [(0, 0)] * x.ndim
    pad[axis] = (r, r)
    xp = np.pad(x, pad, mode="reflect")  # reflect-101: dcb|abcd|cba
    n = x.shape[axis]
    out = np.zeros_like(x)
    for i, w in enumerate(k):
        out += w * np.take(xp, np.arange(i, i + n), axis=axis)
    return out


def gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(img, (0, 0), sigma)`` for float32 ``[H, W]`` /
    ``[H, W, C]``."""
    k = _gaussian_kernel(sigma)
    return _filter_axis(_filter_axis(img.astype(np.float32), k, 1), k, 0)


def _coords(n: int, t: float):
    """Source index and float32 fraction of each of ``n`` outputs at
    ``i + t``, the coordinate summed in float32 as OpenCV 5's warp does."""
    c = np.arange(n, dtype=np.float32) + np.float32(t)
    i = np.floor(c)
    return i.astype(np.int64), c - i


def warp_translate(img: np.ndarray, tx: float, ty: float) -> np.ndarray:
    """``dst(x, y) = src(x + tx, y + ty)``, bilinear, zero outside: the
    ``cv2.warpAffine(img, [[1, 0, -tx], [0, 1, -ty]], (W, H))`` of float32
    ``[H, W, C]``, as OpenCV 5 computes it: float32 source coordinates and
    two linear blends, along x then y (OpenCV 4 rounded the fraction to
    1/32 px)."""
    h, w = img.shape[:2]
    xi, fx = _coords(w, tx)
    yi, fy = _coords(h, ty)
    pad = 2 + int(max(abs(tx), abs(ty)))
    src = np.pad(img, ((pad, pad), (pad, pad)) + ((0, 0),) * (img.ndim - 2))
    rows = src[yi[:, None] + pad + np.array([0, 1])]          # [h, 2, W + 2·pad, ...]
    left, right = rows[:, :, xi + pad], rows[:, :, xi + pad + 1]
    fx = fx.reshape((1, 1, w) + (1,) * (img.ndim - 2))
    blend = left + (right - left) * fx                         # [h, 2, w, ...]
    top, bottom = blend[:, 0], blend[:, 1]
    return top + (bottom - top) * fy.reshape((h, 1) + (1,) * (img.ndim - 2))
