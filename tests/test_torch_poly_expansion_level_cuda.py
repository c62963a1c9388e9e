"""K11, the level route's polynomial expansion (``csrc/poly_expansion_level.cu``),
against its plain version ``ops/farneback_fast.py::_poly_expansion_level_plain``,
bit for bit.

On the card (marked ``cuda``): n 1, 5 and 10 by pad 0 and 4 on a ragged
33 × 130 image (two tiles across, a ragged tile down); autodriving's four
levels (801², 481², 288², 173²) at B = 128 and uav's (161², 97², 58², 35²),
both images of a level in one launch with r1's pad; a 7 × 9 image (smaller
than 2n + 1 = 21); B = 1; PyTorch's ``add_(x, alpha=k)`` rounding once (the
kernel's FMA taps rest on it); ``farneback_fast`` at the autodriving preset
through 'auto' (one K11 launch a level, the flow equal bit for bit to the
flow with the plain expansion put in) and through 'xla' (no K11 launch, and
no K12: the route's pyramid blur is plain torch too).

On the CPU (unmarked): the plain version's pad is the edge extension of
its unpadded result; the kernel's tiling, mirrored here in PyTorch (the
tile's clamped source slab, its vertical sums in row groups of 4, the
horizontal sums of 4-pixel groups, the stage each canvas row of the tile
reads at its clamped source column), equals the plain version at the
kernel's tile and at small tiles that put many tile edges in the pad bands;
the level routes call the wrapper twice a level ('pallas_sep', 'pallas'; on
the CPU the pair takes the plain version of each image) and 'xla' never;
the wrapper's checks raise before any launch.

The card's tests need no jax: ``python -m pytest --noconftest -m cuda
tests/test_torch_poly_expansion_level_cuda.py``.  Skipped without a CUDA
device.
"""

import numpy as np
import pytest
import torch

from nsof_tpu_torch import _build
from nsof_tpu_torch.ops import farneback_fast as tff
from nsof_tpu_torch.ops.farneback import (PRESETS, _effective_levels, _extend,
                                          _poly_exp_coeffs, _tap_sum)

TILE = (16, 128, 4)  # the kernel's canvas rows and columns a tile, rows a vertical group
AD = PRESETS["autodriving"]  # poly_n 10, poly_sigma 1.05
AD_LEVELS = (801, 481, 288, 173)
UAV_LEVELS = (161, 97, 58, 35)
RADIUS = 3


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def bits_equal(got: torch.Tensor, want: torch.Tensor) -> bool:
    return got.shape == want.shape and torch.equal(_bits(got.cpu()), _bits(want.cpu()))


def texture(b: int, h: int, w: int, seed: int) -> torch.Tensor:
    """0–255 float32 images: smooth waves plus noise, varied over the batch."""
    rng = np.random.default_rng(seed)
    ys = np.linspace(0, 5, h, dtype=np.float32)[:, None]
    xs = np.linspace(0, 7, w, dtype=np.float32)[None, :]
    ph = rng.random((b, 1, 1), dtype=np.float32) * 6
    img = 128 + 60 * np.sin(ys + ph) * np.cos(xs - ph) + 40 * rng.random((b, h, w))
    return torch.from_numpy(img.astype(np.float32))


def k11_mirror(img: torch.Tensor, n: int, sigma: float, pad: int,
               tile=TILE) -> torch.Tensor:
    """K11's tiling in PyTorch: per canvas tile, the clamped source slab,
    the vertical sums of its row groups, the horizontal sums of its 4-pixel
    groups, then each canvas row of the tile read from the stage at its
    clamped source columns.  The sums are PyTorch's tap sums, as in the
    plain version: the mirror checks the kernel's indices."""
    tr, tc, rg = tile
    g, xg, xxg, ig11, ig03, ig33, ig55 = _poly_exp_coeffs(n, sigma)
    b, h, w = img.shape
    ho, wo = h + 2 * pad, w + 2 * pad
    out = torch.full((b, 5, ho, wo), float("nan"))
    filled = torch.zeros((ho, wo), dtype=torch.int32)

    def clamp(v, hi):
        return min(max(v, 0), hi - 1)

    for y0 in range(0, ho, tr):
        for x0 in range(0, wo, tc):
            y1, x1 = min(y0 + tr, ho), min(x0 + tc, wo)
            ya, xa = clamp(y0 - pad, h), clamp(x0 - pad, w)
            rows = clamp(y1 - 1 - pad, h) - ya + 1
            cols = clamp(x1 - 1 - pad, w) - xa + 1
            assert rows <= tr and cols <= tc
            srows = rg * -(-rows // rg) + 2 * n
            scols = 4 * -(-cols // 4) + 2 * n
            ridx = (ya - n + torch.arange(srows)).clamp(0, h - 1)
            cidx = (xa - n + torch.arange(scols)).clamp(0, w - 1)
            slab = img.index_select(1, ridx).index_select(2, cidx)
            s0, s1, s2 = (_tap_sum(slab, k, -2, srows - 2 * n) for k in (g, xg, xxg))
            jw = scols - 2 * n
            b1, b2, b3 = _tap_sum(s0, g, -1, jw), _tap_sum(s1, g, -1, jw), _tap_sum(s0, xg, -1, jw)
            b4, b5, b6 = _tap_sum(s0, xxg, -1, jw), _tap_sum(s2, g, -1, jw), _tap_sum(s1, xg, -1, jw)
            stage = torch.stack([b2 * ig11, b3 * ig11, b1 * ig03 + b5 * ig33,
                                 b1 * ig03 + b4 * ig33, b6 * ig55], dim=1)
            j = (torch.arange(x0, x1) - pad).clamp(0, w - 1) - xa
            assert int(j.min()) >= 0 and int(j.max()) < cols
            for r in range(rows):
                ys = ya + r
                ylo = max(0 if ys == 0 else ys + pad, y0)
                yhi = min(ho - 1 if ys == h - 1 else ys + pad, y1 - 1)
                for y in range(ylo, yhi + 1):
                    out[:, :, y, x0:x1] = stage[:, :, r, j]
                    filled[y, x0:x1] += 1
    assert bool((filled == 1).all()), "each canvas pixel written once"
    return out


# -- on the CPU ---------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 33, 130), (1, 7, 9), (3, 20, 17)])
@pytest.mark.parametrize("n", [1, 5, 10])
@pytest.mark.parametrize("pad", [1, 4])
def test_plain_pad_is_the_edge_extension(shape, n, pad):
    img = texture(*shape, seed=n + pad)
    got = tff._poly_expansion_level_plain(img, n, 1.05, pad)
    want = _extend(tff._poly_expansion_level_plain(img, n, 1.05), pad, pad, pad, pad)
    assert bits_equal(got, want)


@pytest.mark.parametrize("tile", [TILE, (4, 8, 4), (8, 12, 4)])
@pytest.mark.parametrize("shape,n,pad", [
    ((2, 33, 130), 10, 0), ((2, 33, 130), 10, 4), ((2, 33, 130), 5, 4),
    ((2, 33, 130), 1, 0), ((1, 7, 9), 10, 4), ((2, 20, 17), 5, 11),
    ((1, 1, 5), 3, 2), ((1, 6, 1), 2, 3),
])
def test_k11_mirror_equals_plain(tile, shape, n, pad):
    img = texture(*shape, seed=7 * n + pad)
    want = tff._poly_expansion_level_plain(img, n, 1.05, pad)
    assert bits_equal(k11_mirror(img, n, 1.05, pad, tile), want)


@pytest.mark.parametrize("mode,calls_a_level", [("pallas_sep", 2), ("pallas", 2), ("xla", 0)])
def test_level_routes_call_the_wrapper(monkeypatch, mode, calls_a_level):
    calls = []
    wrapped = tff.poly_expansion_fast

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return wrapped(*args, **kwargs)

    monkeypatch.setattr(tff, "poly_expansion_fast", counted)
    b, h, w = 2, 96, 112  # three levels
    prev = texture(b, h, w, seed=1).to(torch.uint8)
    nxt = torch.roll(prev, (1, -2), dims=(1, 2))
    want_levels = _effective_levels(h, w, AD.levels, AD.pyr_scale) + 1
    tff.farneback_fast(prev, nxt, AD, RADIUS, mode, device="cpu")
    assert want_levels == 3 and len(calls) == calls_a_level * want_levels


def test_cpu_tensors_launch_nothing():
    _build.reset_launches()
    img = texture(2, 30, 40, seed=3)
    r0, r1p = tff.poly_expansion_pair(img, img.flip(-1), 10, 1.05, 4)
    assert not any(_build.LAUNCHES.values())
    assert bits_equal(r0, tff._poly_expansion_level_plain(img, 10, 1.05))
    assert bits_equal(r1p, tff._poly_expansion_level_plain(img.flip(-1), 10, 1.05, 4))
    assert bits_equal(tff.poly_expansion_fast(img, 5, 1.2, 3),
                      tff._poly_expansion_level_plain(img, 5, 1.2, 3))
    assert not any(_build.LAUNCHES.values())


def _bad_args(case: str):
    img = texture(2, 30, 40, seed=4)
    if case == "dtype":
        return (img.double(),), 10, (0,)
    if case == "strides":
        return (img.transpose(1, 2),), 10, (0,)
    if case == "shapes":
        return (img, img[:, :29]), 10, (0, 4)
    if case == "rank":
        return (img[0],), 10, (0,)
    if case == "n_over_limit":
        return (img,), tff.LEVEL_MAX_N + 1, (0,)
    if case == "n_zero":
        return (img,), 0, (0,)
    return (img, img), 10, (0, -1)  # negative pad


@pytest.mark.parametrize("case", ["dtype", "strides", "shapes", "rank", "n_over_limit",
                                  "n_zero", "negative_pad"])
def test_kernel_wrapper_checks_raise(case):
    """The wrapper refuses what the kernel does not take, before any launch."""
    _build.reset_launches()
    imgs, n, pads = _bad_args(case)
    with pytest.raises(ValueError):
        tff._poly_expansion_level_cuda(imgs, n, 1.05, pads)
    assert _build.LAUNCHES["poly_expansion_level"] == 0


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _pair_on_card(dev, b, h, w, n, sigma, pad1, seed):
    """K11 on a level's two images in one launch against the plain version
    of each, bit for bit."""
    i0 = texture(b, h, w, seed).to(dev)
    i1 = texture(b, h, w, seed + 1).to(dev)
    _build.reset_launches()
    r0, r1p = tff.poly_expansion_pair(i0, i1, n, sigma, pad1)
    torch.cuda.synchronize()
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {"poly_expansion_level": 1}
    assert bits_equal(r0, tff._poly_expansion_level_plain(i0, n, sigma))
    assert bits_equal(r1p, tff._poly_expansion_level_plain(i1, n, sigma, pad1))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 5, 10])
@pytest.mark.parametrize("pad", [0, 4])
def test_k11_matches_plain(cuda_device, n, pad):
    img = texture(3, 33, 130, seed=n + pad).to(cuda_device)
    _build.reset_launches()
    got = tff.poly_expansion_fast(img, n, 1.05, pad)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["poly_expansion_level"] == 1
    assert bits_equal(got, tff._poly_expansion_level_plain(img, n, 1.05, pad))


@pytest.mark.cuda
@pytest.mark.parametrize("size", AD_LEVELS)
def test_k11_autodriving_levels(cuda_device, size):
    _pair_on_card(cuda_device, 128, size, size, AD.poly_n, AD.poly_sigma, RADIUS + 1,
                  seed=size)


@pytest.mark.cuda
@pytest.mark.parametrize("size", UAV_LEVELS)
def test_k11_uav_levels(cuda_device, size):
    uav = PRESETS["uav"]
    _pair_on_card(cuda_device, 16, size, size, uav.poly_n, uav.poly_sigma, RADIUS + 1,
                  seed=size)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,n,pad1", [
    (2, 33, 130, 10, 4),   # ragged tiles both ways
    (3, 7, 9, 10, 4),      # smaller than 2n + 1
    (1, 801, 801, 10, 4),  # B = 1
    (1, 1, 300, 10, 11),   # one row, a pad wider than the tile's rows
    (2, 50, 70, 64, 3),    # the widest n
])
def test_k11_edges(cuda_device, b, h, w, n, pad1):
    _pair_on_card(cuda_device, b, h, w, n, 1.05 if n == 10 else 0.0, pad1, seed=h + w)


@pytest.mark.cuda
def test_k11_refuses_wider_n(cuda_device):
    img = texture(1, 20, 20, seed=0).to(cuda_device)
    with pytest.raises(ValueError):
        tff.poly_expansion_fast(img, tff.LEVEL_MAX_N + 1, 0.0)


@pytest.mark.cuda
def test_torch_add_alpha_rounds_once(cuda_device):
    """PyTorch's CUDA ``a.add_(b, alpha=k)`` rounds a + k·b once (an FMA),
    which K11's taps reproduce with __fmaf_rn.  With a in ±[1, 2) and b, k
    in [1, 2), a + k·b is exact in float64, so its float32 rounding is the
    FMA's; rounding k·b first differs on some of these inputs."""
    rng = np.random.default_rng(0)
    a = (rng.random(1 << 16) + 1) * rng.choice([-1, 1], 1 << 16)
    b = rng.random(1 << 16) + 1
    a, b = a.astype(np.float32), b.astype(np.float32)
    for k in np.float32([1.0625, 1.3371, 1.99999]):
        got = torch.from_numpy(a).to(cuda_device).add_(torch.from_numpy(b).to(cuda_device),
                                                       alpha=float(k)).cpu().numpy()
        once = (a.astype(np.float64) + np.float64(k) * b.astype(np.float64)).astype(np.float32)
        twice = (a + (k * b).astype(np.float32)).astype(np.float32)
        assert np.array_equal(got.view(np.int32), once.view(np.int32))
        assert not np.array_equal(got.view(np.int32), twice.view(np.int32))


def _ad_frames(dev, b=4, seed=5):
    prev = texture(b, 801, 801, seed).to(torch.uint8)
    nxt = torch.roll(prev, (2, -1), dims=(1, 2))
    return prev.to(dev), nxt.to(dev)


@pytest.mark.cuda
def test_farneback_auto_takes_k11_once_a_level(cuda_device, monkeypatch):
    prev, nxt = _ad_frames(cuda_device)
    levels = _effective_levels(801, 801, AD.levels, AD.pyr_scale) + 1
    _build.reset_launches()
    got = tff.farneback_fast(prev, nxt, AD, RADIUS, "auto")
    torch.cuda.synchronize()
    assert _build.LAUNCHES["poly_expansion_level"] == levels == 4
    assert _build.LAUNCHES["update_matrices_sep_level"] == levels * AD.iterations

    monkeypatch.setattr(tff, "poly_expansion_pair", tff._poly_expansion_pair_plain)
    _build.reset_launches()
    want = tff.farneback_fast(prev, nxt, AD, RADIUS, "auto")
    assert _build.LAUNCHES["poly_expansion_level"] == 0
    assert bits_equal(got, want)


@pytest.mark.cuda
def test_farneback_xla_launches_no_k11(cuda_device):
    prev, nxt = _ad_frames(cuda_device, b=1)
    _build.reset_launches()
    tff.farneback_fast(prev[:, :200, :200].contiguous(), nxt[:, :200, :200].contiguous(),
                       AD, 1, "xla")
    torch.cuda.synchronize()
    assert _build.LAUNCHES["poly_expansion_level"] == _build.LAUNCHES["pyramid_blur"] == 0
    assert not any(_build.LAUNCHES.values())
