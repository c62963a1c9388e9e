"""K12, the Farnebäck pyramid's reflect-101 pad and blur (``csrc/pyramid_blur.cu``),
against its plain version ``ops/farneback_fast.py::_pyramid_blur_plain``, bit
for bit.

On the card (marked ``cuda``): every ``chip_smoke.K12_CASES`` case, both
images of a level in one launch (the Farnebäck cells' own levels at B = 128:
autodriving's four blurs of the 801² originals with 9, 5, 3 and 3 taps,
grasp's 1920×1080 with 3 and 960×540 and 480×270 with 7; t = 1; n = H − 1
and n = W − 1; ragged tiles; one row and one column beyond a tile of each
template instance; B = 1; the generic instance's chunks of columns; grids
past the launch's y and z limits); the wrapper's refusal of n ≥ H on the
card; ``farneback_fast`` at the autodriving and grasp presets through
'auto' (one K12 launch a level, the flow equal bit for bit to the flow with
the plain pad and blur put in).  That 'xla' launches neither K11 nor K12 is
``tests/test_torch_poly_expansion_level_cuda.py``'s card test.

On the CPU (unmarked): the wrapper on CPU tensors is the plain pad and blur
of each image; the kernel's tiling, mirrored here in PyTorch (a tile's
reflect-indexed haloed columns, their vertical sums, the horizontal sums of
each output column over the taps whose column lies in a chunk, in tap
order), equals the plain version for the template instances and the
generic one, at the kernel's tile and at small tiles; every route but 'xla'
calls the wrapper once a level, and K12_CASES' cell cases are the shapes and
taps those calls get at the cells' presets; CPU tensors launch nothing; the
wrapper's refusals raise before any launch.

The card's tests need no jax: ``python -m pytest --noconftest -m cuda
tests/test_torch_pyramid_blur_cuda.py``.  Skipped without a CUDA device.
"""

import numpy as np
import pytest
import torch

from chip_smoke import K12_CASES, K12_LEVELS, bits_equal, k11_images
from nsof_tpu_torch import _build
from nsof_tpu_torch.config import DATASETS
from nsof_tpu_torch.ops import farneback_fast as tff
from nsof_tpu_torch.ops.farneback import (PRESETS, _blur_valid, _effective_levels,
                                          _gaussian_blur_kernel, _reflect_pad)

TILE = (32, 128)  # the kernel's output rows and haloed columns a tile
AD = PRESETS["autodriving"]
GRASP = PRESETS["grasp"]
RADIUS = 3


def texture(b: int, h: int, w: int, seed: int) -> torch.Tensor:
    """0–255 float32 images: smooth waves plus noise, varied over the batch."""
    rng = np.random.default_rng(seed)
    ys = np.linspace(0, 5, h, dtype=np.float32)[:, None]
    xs = np.linspace(0, 7, w, dtype=np.float32)[None, :]
    ph = rng.random((b, 1, 1), dtype=np.float32) * 6
    img = 128 + 60 * np.sin(ys + ph) * np.cos(xs - ph) + 40 * rng.random((b, h, w))
    return torch.from_numpy(img.astype(np.float32))


def _plain_one(img: torch.Tensor, k) -> torch.Tensor:
    return _blur_valid(_reflect_pad(img, len(k) // 2), k)


def _reflect(i: torch.Tensor, size: int) -> torch.Tensor:
    i = i.abs()
    i = torch.where(i >= size, 2 * (size - 1) - i, i)
    return i.clamp(0, size - 1)


def k12_mirror(img: torch.Tensor, k, generic: bool, tile=TILE) -> torch.Tensor:
    """K12's tiling in PyTorch.  A tile of ``rows`` output rows takes
    ``cols − 2n`` output columns (template instances, one chunk) or ``cols``
    (the generic instance, its haloed columns in chunks of ``cols``); a
    chunk's haloed columns are source columns r(X0 − n + c·cols + j), whose
    vertical sums over reflect-indexed rows each output column adds for the
    taps s with j + s in the chunk.  Products and sums are rounded one at a
    time as in the kernel: the mirror checks its indices and tap order."""
    rows, cols = tile
    t = len(k)
    n = t // 2
    b, h, w = img.shape
    tco = cols if generic else cols - 2 * n
    assert tco > 0
    chunks = -(-(cols + 2 * n) // cols) if generic else 1
    out = torch.full((b, h, w), float("nan"))
    for y0 in range(0, h, rows):
        ridx = _reflect(torch.arange(y0 - n, y0 + rows + n), h)
        for x0 in range(0, w, tco):
            acc = None
            j = torch.arange(tco)
            for c in range(chunks):
                cidx = _reflect(torch.arange(x0 - n + c * cols, x0 - n + (c + 1) * cols), w)
                slab = img.index_select(1, ridx).index_select(2, cidx)
                v = None
                for s in range(t):
                    term = float(k[s]) * slab[:, s : s + rows]
                    v = term if v is None else v + term
                for s in range(t):
                    col = j + s - c * cols
                    inside = (col >= 0) & (col < cols)
                    if not bool(inside.any()):
                        continue
                    term = float(k[s]) * v[:, :, col.clamp(0, cols - 1)]
                    if s == 0:
                        assert c == 0 and bool(inside.all())
                        acc = term
                    else:
                        acc = torch.where(inside, acc + term, acc)
            y1, x1 = min(y0 + rows, h), min(x0 + tco, w)
            out[:, y0:y1, x0:x1] = acc[:, : y1 - y0, : x1 - x0]
    assert not bool(out.isnan().any()), "each output written"
    return out


# -- on the CPU ---------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 33, 130), (1, 10, 9), (3, 5, 300)])
@pytest.mark.parametrize("t,sigma", [(1, 0.0), (3, 0.0), (5, 0.9), (9, 1.8)])
def test_wrapper_on_cpu_is_the_plain_blur(shape, t, sigma):
    k = _gaussian_blur_kernel(t, sigma)
    i0, i1 = texture(*shape, seed=t), texture(*shape, seed=t + 1)
    got = tff.pyramid_blur(i0, i1, k)
    assert bits_equal(got[0], _plain_one(i0, k)) and bits_equal(got[1], _plain_one(i1, k))


@pytest.mark.parametrize("tile", [TILE, (4, 12), (3, 20)])
@pytest.mark.parametrize("shape,t", [
    ((2, 33, 130), 3), ((2, 33, 130), 9), ((1, 5, 11), 9), ((2, 40, 23), 5),
    ((1, 1, 7), 1), ((2, 9, 1), 1), ((1, 12, 30), 11),
])
def test_k12_template_mirror_equals_plain(tile, shape, t):
    k = _gaussian_blur_kernel(t, 0.4 * t)
    img = texture(*shape, seed=3 * t + tile[0])
    assert bits_equal(k12_mirror(img, k, generic=False, tile=tile), _plain_one(img, k))


@pytest.mark.parametrize("tile,shape,t", [
    *[(tile, shape, t) for tile in (TILE, (4, 8), (5, 3))
      for shape, t in (((2, 33, 130), 11), ((1, 7, 40), 13), ((2, 20, 17), 25),
                       ((1, 3, 50), 5), ((1, 6, 1), 1))],
    (TILE, (1, 130, 300), 257),
])
def test_k12_generic_mirror_equals_plain(tile, shape, t):
    k = _gaussian_blur_kernel(t, 0.3 * t)
    img = texture(*shape, seed=5 * t + tile[1])
    assert bits_equal(k12_mirror(img, k, generic=True, tile=tile), _plain_one(img, k))


def _fake_kernels(monkeypatch, calls):
    """Record the wrapper's calls; every kernel wrapper returns zeros of its
    output's shape, so that a route runs its pyramid glue at a cell's size
    on the CPU in a moment."""
    def blur(i0, i1, k):
        calls.append((tuple(i0.shape), np.asarray(k, np.float32)))
        return torch.zeros_like(i0), torch.zeros_like(i1)

    def zeros(*shape):
        return torch.zeros(shape)

    monkeypatch.setattr(tff, "pyramid_blur", blur)
    monkeypatch.setattr(tff, "poly_expansion", lambda img, n, s, hp, wp, blur=None,
                        margin=(0, 0): zeros(img.shape[0], 5, hp + 2 * margin[0],
                                             wp + 2 * margin[1]))
    monkeypatch.setattr(tff, "update_matrices_sep", lambda dx, dy, r0, *a, **kw:
                        torch.zeros_like(r0))
    monkeypatch.setattr(tff, "fused_box_update", lambda m, r0, r1, bsc, ws, r, emit:
                        zeros(m.shape[0], 5 if emit == "matrices" else 2, *m.shape[2:]))
    monkeypatch.setattr(tff, "poly_expansion_pair", lambda i0, i1, n, s, p: (
        zeros(i0.shape[0], 5, *i0.shape[1:]),
        zeros(i0.shape[0], 5, i0.shape[1] + 2 * p, i0.shape[2] + 2 * p)))
    monkeypatch.setattr(tff, "update_matrices", lambda dx, dy, r0, *a, **kw: torch.zeros_like(r0))
    monkeypatch.setattr(tff, "box_solve", lambda m, ws: (zeros(m.shape[0], *m.shape[2:]),) * 2)


@pytest.mark.parametrize("cell", sorted(K12_LEVELS))
def test_card_cases_are_the_cells_levels(monkeypatch, cell):
    """The wrapper's calls at a cell's preset and frame size are K12_LEVELS'
    shapes and taps, in order: the card cases are the cells' own."""
    calls = []
    _fake_kernels(monkeypatch, calls)
    cfg = DATASETS[cell]
    frames = torch.zeros((1, cfg.image_h, cfg.image_w), dtype=torch.uint8)
    tff.farneback_fast(frames, frames, cfg.fb, cfg.warp_radius, "auto", device="cpu")
    want = [((1, h, w), _gaussian_blur_kernel(t, sigma)) for _, h, w, t, sigma in K12_LEVELS[cell]]
    assert [c[0] for c in calls] == [s for s, _ in want]
    for (_, got), (_, taps) in zip(calls, want):
        assert got.dtype == taps.dtype and np.array_equal(got, taps)


@pytest.mark.parametrize("mode,preset,calls_a_level", [
    ("fused", GRASP, 1), ("fused_f32", GRASP, 1), ("pallas_sep", AD, 1), ("pallas", AD, 1),
    ("xla", AD, 0),
])
def test_routes_call_the_wrapper_once_a_level(monkeypatch, mode, preset, calls_a_level):
    """The fused routes blur levels 1 … L, the level routes every level,
    through the wrapper; 'xla' never calls it."""
    calls = []
    wrapped = tff.pyramid_blur

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return wrapped(*args, **kwargs)

    monkeypatch.setattr(tff, "pyramid_blur", counted)
    b, h, w = 2, 96, 112
    prev = texture(b, h, w, seed=1).to(torch.uint8)
    nxt = torch.roll(prev, (1, -2), dims=(1, 2))
    levels = _effective_levels(h, w, preset.levels, preset.pyr_scale)
    blurred = levels if mode.startswith("fused") else levels + 1
    tff.farneback_fast(prev, nxt, preset, RADIUS, mode, device="cpu")
    assert levels >= 1 and len(calls) == calls_a_level * blurred


def test_cpu_tensors_launch_nothing():
    _build.reset_launches()
    i0, i1 = texture(2, 30, 40, seed=3), texture(2, 30, 40, seed=4)
    k = _gaussian_blur_kernel(7, 1.1)
    got = tff.pyramid_blur(i0, i1, k)
    assert not any(_build.LAUNCHES.values())
    want = tff._pyramid_blur_plain(i0, i1, k)
    assert bits_equal(got[0], want[0]) and bits_equal(got[1], want[1])


def _bad_args(case: str):
    img = texture(2, 9, 12, seed=4)
    k3 = _gaussian_blur_kernel(3, 0.0)
    if case == "even_taps":
        return img, img, np.full(4, 0.25, np.float32)
    if case == "taps_2d":
        return img, img, np.ones((3, 3), np.float32)
    if case == "n_is_h":
        return img, img, _gaussian_blur_kernel(19, 3.0)  # n = 9 = H
    if case == "n_is_w":
        tall = texture(2, 30, 5, seed=4)
        return tall, tall, _gaussian_blur_kernel(11, 2.0)  # n = 5 = W
    if case == "dtype":
        return img.double(), img.double(), k3
    if case == "device":
        return img, torch.empty(img.shape, device="meta"), k3
    if case == "shapes":
        return img, img[:, :8].contiguous(), k3
    if case == "strides":
        wide = texture(2, 12, 9, seed=4)
        return img, wide.transpose(1, 2), k3
    return img[0], img[0], k3  # rank


@pytest.mark.parametrize("case", ["even_taps", "taps_2d", "n_is_h", "n_is_w", "dtype", "device",
                                  "shapes", "strides", "rank"])
def test_wrapper_checks_raise(case):
    """The wrapper refuses what K12 does not take, before any launch."""
    _build.reset_launches()
    i0, i1, k = _bad_args(case)
    with pytest.raises(ValueError):
        tff.pyramid_blur(i0, i1, k)
    assert _build.LAUNCHES["pyramid_blur"] == 0


def test_wrapper_takes_n_up_to_h_and_w_less_one():
    img = texture(2, 5, 5, seed=6)
    k = _gaussian_blur_kernel(9, 1.8)  # n = 4 = H − 1 = W − 1
    got = tff.pyramid_blur(img, img.flip(-1).contiguous(), k)
    assert bits_equal(got[0], _plain_one(img, k))


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(K12_CASES))
def test_k12_matches_plain(cuda_device, name):
    b, h, w, t, sigma = K12_CASES[name]
    k = _gaussian_blur_kernel(t, sigma)
    i0, i1 = k11_images(b, h, w, len(name), cuda_device)
    _build.reset_launches()
    got = tff.pyramid_blur(i0, i1, k)
    torch.cuda.synchronize()
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {"pyramid_blur": 1}
    want = tff._pyramid_blur_plain(i0, i1, k)
    assert bits_equal(got[0], want[0]) and bits_equal(got[1], want[1])


@pytest.mark.cuda
def test_k12_refuses_n_at_h(cuda_device):
    img = texture(1, 4, 20, seed=0).to(cuda_device)
    _build.reset_launches()
    with pytest.raises(ValueError):
        tff.pyramid_blur(img, img, _gaussian_blur_kernel(9, 1.8))
    assert _build.LAUNCHES["pyramid_blur"] == 0


def _frames(dev, b, h, w, seed):
    prev = texture(b, h, w, seed).to(torch.uint8)
    nxt = torch.roll(prev, (2, -1), dims=(1, 2))
    return prev.to(dev), nxt.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(K12_LEVELS))
def test_farneback_auto_takes_k12_once_a_level(cuda_device, monkeypatch, cell):
    cfg = DATASETS[cell]
    prev, nxt = _frames(cuda_device, 4, cfg.image_h, cfg.image_w, seed=5)
    _build.reset_launches()
    got = tff.farneback_fast(prev, nxt, cfg.fb, cfg.warp_radius, "auto")
    torch.cuda.synchronize()
    assert _build.LAUNCHES["pyramid_blur"] == len(K12_LEVELS[cell])

    monkeypatch.setattr(tff, "pyramid_blur", tff._pyramid_blur_plain)
    _build.reset_launches()
    want = tff.farneback_fast(prev, nxt, cfg.fb, cfg.warp_radius, "auto")
    assert _build.LAUNCHES["pyramid_blur"] == 0
    assert bits_equal(got, want)
