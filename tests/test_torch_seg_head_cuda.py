"""K10, the seg head's kernel (``csrc/seg_head.cu``), against its plain
version ``ops/morphology_fast.py::seg_head_plain``, bit for bit.

On the card (marked ``cuda``): widths 1080 and 801 and the ragged widths 1,
31, 32, 33, 63 and 65, by SE size 3, 5, 10 and 11, by 1, 3 and 5 iterations,
on samples with a box inside the frame, boxes touching each frame edge, the
whole frame, a box mask that is no rectangle and an inactive sample (box
mask all False); |flow|² at SEG_TH² rounded to float32 and one ulp either
side of it; the widest SE (31) at the widest row (8,192 columns, the
kernel's opted-in shared memory); no iteration; the interleaved ``[B, h, w,
2]`` flow of ``seg_head_window_batch``; one ``_build.LAUNCHES["seg_head"]``
a call.

On the CPU (unmarked): CPU tensors take the plain version and launch
nothing; the wrapper's checks raise before any launch; and the kernel's
algorithm, mirrored here in numpy (the pack into 32-column words, the
tiles of packed rows staged with their halo, each SE run as a 64-bit window
of three words OR-ed over its rows and widened by shift doubling, the
ping-pong of passes), equals the plain version at small tiles.

The card's tests need no jax: ``python -m pytest --noconftest -m cuda
tests/test_torch_seg_head_cuda.py``.  Skipped without a CUDA device.
"""

import numpy as np
import pytest
import torch

from nsof_tpu_torch import _build
from nsof_tpu_torch.ops import morphology_fast as tmf
from nsof_tpu_torch.ops.morphology import ellipse_se
from nsof_tpu_torch.pipelines import segmentation as tseg

WIDTHS = (1080, 801, 1, 31, 32, 33, 63, 65)
KSIZES = (3, 5, 10, 11)
ITERS = (1, 3, 5)
TH = 1.1  # SEG_TH² = 1.21 is not a float32: the comparison's rounding shows


def _boxes(b: int, h: int, w: int, rng) -> np.ndarray:
    """Box masks: one inside the frame, one touching each edge, the whole
    frame, a random field, an inactive sample (all False), cycled over b."""
    kinds = ("inside", "top", "bottom", "left", "right", "whole", "field", "inactive")
    ib = np.zeros((b, h, w), bool)
    for i in range(b):
        kind = kinds[i % len(kinds)]
        y0, y1 = sorted(rng.integers(0, h + 1, 2))
        x0, x1 = sorted(rng.integers(0, w + 1, 2))
        y1, x1 = max(y1, y0 + 1), max(x1, x0 + 1)
        if kind == "top":
            y0 = 0
        elif kind == "bottom":
            y1 = h
        elif kind == "left":
            x0 = 0
        elif kind == "right":
            x1 = w
        if kind == "whole":
            ib[i] = True
        elif kind == "field":
            ib[i] = rng.random((h, w)) < 0.85
        elif kind != "inactive":
            ib[i, y0:y1, x0:x1] = True
    return ib


def _threshold_pairs(th2: float):
    """(dx, dy) float32 pairs whose |flow|², rounded as the kernel rounds it,
    is the float32 SEG_TH², the float32 below it and the float32 above it."""
    t = np.float32(th2)
    want = {np.nextafter(t, np.float32(0)): None, t: None, np.nextafter(t, np.float32(9)): None}
    base = np.float32(np.sqrt(th2))
    dxs = base + np.arange(-64, 65, dtype=np.float32) * np.spacing(base)
    dys = np.arange(0, 64, dtype=np.float32) * np.float32(1e-4)
    for dx in dxs:
        for dy in dys:
            m2 = np.float32(np.float32(dx * dx) + np.float32(dy * dy))
            if m2 in want and want[m2] is None:
                want[m2] = (dx, dy)
    assert all(v is not None for v in want.values())
    return list(want.values())


def head_inputs(b: int, h: int, w: int, seed: int, th: float = TH):
    """Flow planes ``[b, h, w]`` float32 (a smooth field about SEG_TH with
    noise, so the mask has blobs and specks; every eighth pixel of the
    first row of each sample at SEG_TH² or one ulp beside it) and box masks
    (:func:`_boxes`), as CPU tensors."""
    rng = np.random.default_rng(seed)
    ys = np.linspace(0, 3 * np.pi, h)[:, None]
    xs = np.linspace(0, 4 * np.pi, w)[None, :]
    phase = rng.random((b, 1, 1)) * 6.0
    smooth = th * (1.0 + 0.6 * np.sin(ys + phase) * np.cos(xs - phase))
    mag = smooth + rng.normal(scale=0.25 * th, size=(b, h, w))
    ang = rng.random((b, h, w)) * 2 * np.pi
    dx = (mag * np.cos(ang)).astype(np.float32)
    dy = (mag * np.sin(ang)).astype(np.float32)
    pairs = _threshold_pairs(th * th)
    for k, c in enumerate(range(0, w, 8)):
        dx[:, 0, c], dy[:, 0, c] = pairs[k % len(pairs)]
    return torch.from_numpy(dx), torch.from_numpy(dy), torch.from_numpy(_boxes(b, h, w, rng))


# -- the kernel's algorithm in numpy (the CPU mirror) ------------------------

def _pack(x: np.ndarray) -> np.ndarray:
    """[b, h, w] bool → [b, h, ⌈w/32⌉] words, bit j of word i = column
    32 i + j, zero tail."""
    b, h, w = x.shape
    nw = (w + 31) // 32
    bits = np.zeros((b, h, nw * 32), np.uint64)
    bits[..., :w] = x
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)
    return (bits.reshape(b, h, nw, 32) * weights).sum(-1).astype(np.uint64)


def _window64(p: np.ndarray, left: int) -> np.ndarray:
    """Bits 32 i + left .. + 63 of each row of words ``p`` [..., nw]."""
    a = np.zeros_like(p)
    a[..., 1:] = p[..., :-1]
    c = np.zeros_like(p)
    c[..., :-1] = p[..., 1:]
    m32 = np.uint64(0xFFFFFFFF)
    s = 32 + left

    def fshr(lo, hi, k):  # __funnelshift_r
        return (((hi << np.uint64(32)) | lo) >> np.uint64(k)) & m32

    if s < 32:
        lo, hi = fshr(a, p, s), fshr(p, c, s)
    else:
        lo, hi = fshr(p, c, s - 32), c >> np.uint64(s - 32)
    return (hi << np.uint64(32)) | lo


def _or_over_se(p: np.ndarray, r0: int, n: int, runs) -> np.ndarray:
    """OR_SE of staged plane ``p`` [b, rows, nw] at its rows r0 .. r0 + n."""
    acc = np.zeros((p.shape[0], n, p.shape[2]), np.uint64)
    for left, right, dys in runs:
        k = right - left + 1
        u = np.zeros_like(acc)
        for dy in dys:
            u |= _window64(p[:, r0 + dy : r0 + dy + n], left)
        span = 1
        while 2 * span <= k:
            u |= u >> np.uint64(span)
            span *= 2
        if span < k:
            u |= u >> np.uint64(k - span)
        acc |= u & np.uint64(0xFFFFFFFF)
    return acc


def k10_mirror(dx, dy, inbox, th2: float, se: np.ndarray, iters: int, tile: int):
    """K10's passes in numpy on CPU tensors → uint8 {0, 255} [b, h, w]."""
    t = tmf._se_table(se).tolist()
    n_runs, rows_at = t[0], 2 + 3 * t[0]
    runs = []
    for g in range(n_runs):
        left, right, count = t[2 + 3 * g : 5 + 3 * g]
        runs.append((left, right, t[rows_at : rows_at + count]))
        rows_at += count
    reach = max(abs(d) for _, _, dys in runs for d in dys) if iters else 0
    dxn, dyn, ibn = dx.numpy(), dy.numpy(), inbox.numpy()
    x = (np.float32(dxn * dxn) + np.float32(dyn * dyn) > np.float32(th2)) & ibn
    xa, ib = _pack(x), _pack(ibn)
    b, h, w = x.shape
    halo = 2 * reach
    out = np.zeros((b, h, w), np.uint8)
    full = np.uint64(0xFFFFFFFF)
    for p in range(max(iters, 1)):
        nxt = np.zeros_like(xa)
        for y0 in range(0, h, tile):
            rows = min(tile, h - y0)

            def stage(plane):
                s = np.zeros((b, rows + 2 * halo, plane.shape[2]), np.uint64)
                lo, hi = max(y0 - halo, 0), min(y0 + rows + halo, h)
                s[:, lo - (y0 - halo) : hi - (y0 - halo)] = plane[:, lo:hi]
                return s

            ibs = stage(ib)
            xs = stage(xa) & ibs
            if iters:
                ds = ~_or_over_se(xs, reach, rows + 2 * reach, runs) & full
                ds &= ibs[:, reach : reach + rows + 2 * reach]
                e = ~_or_over_se(ds, reach, rows, runs) & full
            else:
                e = xs[:, halo : halo + rows]
            nxt[:, y0 : y0 + rows] = e
            if p == max(iters, 1) - 1:
                e = e & ibs[:, halo : halo + rows]
                cols = np.arange(w)
                bits = (e[..., cols // 32] >> (cols % 32).astype(np.uint64)) & np.uint64(1)
                out[:, y0 : y0 + rows] = bits.astype(np.uint8) * 255
        xa = nxt
    return torch.from_numpy(out)


@pytest.mark.parametrize("ksize", KSIZES + (31,))
@pytest.mark.parametrize("width", (1, 31, 32, 33, 63, 65, 101))
def test_k10_mirror_equals_plain(width, ksize):
    """The kernel's algorithm at 8-row tiles (ragged last tile) equals the
    plain head bit for bit, at 0, 1 and 3 iterations."""
    dx, dy, ib = head_inputs(8, 37, width, seed=width * 100 + ksize)
    se = ellipse_se(ksize, ksize)
    for iters in (0, 1, 3):
        want = tmf.seg_head_plain(dx, dy, ib, TH * TH, se, iters)
        got = k10_mirror(dx, dy, ib, TH * TH, se, iters, tile=8)
        assert torch.equal(got, want), iters
    assert want.any() and not want.all()


def test_k10_mirror_threshold_ulps():
    """At no iteration the mask is the threshold itself: pixels at the
    float32 SEG_TH² stay 0, those one ulp above are set, one ulp below 0."""
    dx, dy, ib = head_inputs(2, 4, 48, seed=5)
    ib[:] = True
    se = ellipse_se(3, 3)
    got = k10_mirror(dx, dy, ib, TH * TH, se, 0, tile=8)
    assert torch.equal(got, tmf.seg_head_plain(dx, dy, ib, TH * TH, se, 0))
    first = got[:, 0, ::8]
    assert first[:, 0::3].eq(0).all() and first[:, 1::3].eq(0).all()
    assert first[:, 2::3].eq(255).all()


def test_se_table_groups_rows_by_run():
    t = tmf._se_table(ellipse_se(10, 10)).tolist()
    assert t[:2] == [4, 10]
    runs = [tuple(t[2 + 3 * g : 5 + 3 * g]) for g in range(4)]
    assert runs == [(0, 0, 1), (-3, 3, 2), (-4, 4, 2), (-5, 4, 5)]
    assert t[14:] == [-5, -4, 4, -3, 3, -2, -1, 0, 1, 2]


def test_cpu_tensors_take_the_plain_version():
    from nsof_tpu_torch.config import DATASETS

    dx, dy, ib = head_inputs(3, 20, 40, seed=1)
    se = ellipse_se(10, 10)
    _build.reset_launches()
    got = tmf.seg_head(dx, dy, ib, TH * TH, se, 5)
    assert torch.equal(got, tmf.seg_head_plain(dx, dy, ib, TH * TH, se, 5))
    cfg = DATASETS["grasp"]
    flow = torch.stack([dx, dy], dim=-1)
    got = tseg.seg_head_window_batch(flow, ib, cfg)
    assert torch.equal(got, tmf.seg_head_plain(dx, dy, ib, cfg.head.seg_th ** 2, se,
                                               cfg.head.morph_iters))
    assert not any(_build.LAUNCHES.values())


def _bad_args(case: str):
    dx, dy, ib = head_inputs(2, 9, 40, seed=2)
    se, iters = ellipse_se(10, 10), 5
    if case == "dtype_flow":
        dx = dx.double()
    elif case == "dtype_inbox":
        ib = ib.to(torch.uint8)
    elif case == "shape":
        ib = ib[:, :, :-1]
    elif case == "rank":
        dx, dy, ib = dx[0], dy[0], ib[0]
    elif case == "strides":
        dy = dy.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "se_not_solid":
        se = np.ones((3, 3), np.uint8)
        se[1, 1] = 0
    elif case == "se_empty":
        se = np.zeros((3, 3), np.uint8)
    elif case == "ksize_over_limit":
        se = ellipse_se(tmf.SEG_HEAD_MAX_KSIZE + 2, tmf.SEG_HEAD_MAX_KSIZE + 2)
    elif case == "width_over_limit":
        w = tmf.SEG_HEAD_MAX_WIDTH + 1
        dx, dy, ib = (torch.zeros((1, 1, w)), torch.zeros((1, 1, w)),
                      torch.zeros((1, 1, w), dtype=torch.bool))
    elif case == "negative_iterations":
        iters = -1
    elif case == "cpu_tensors":
        pass
    return dx, dy, ib, TH * TH, se, iters


@pytest.mark.parametrize("case", ["dtype_flow", "dtype_inbox", "shape", "rank", "strides",
                                  "se_not_solid", "se_empty", "ksize_over_limit",
                                  "width_over_limit", "negative_iterations", "cpu_tensors"])
def test_kernel_wrapper_checks_raise(case):
    """The wrapper refuses what the kernel does not take, before any launch
    (CPU tensors included: the kernel wrapper never runs the plain version)."""
    _build.reset_launches()
    with pytest.raises(ValueError):
        tmf._seg_head_cuda(*_bad_args(case))
    assert _build.LAUNCHES["seg_head"] == 0


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _on_card(dev, dx, dy, ib, th2, se, iters):
    """K10 against the plain version on the card: equal, one launch."""
    dx, dy, ib = dx.to(dev), dy.to(dev), ib.to(dev)
    _build.reset_launches()
    got = tmf.seg_head(dx, dy, ib, th2, se, iters)
    torch.cuda.synchronize()
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {"seg_head": 1}
    want = tmf.seg_head_plain(dx, dy, ib, th2, se, iters)
    assert got.dtype == torch.uint8 and got.shape == want.shape
    assert torch.equal(got, want)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("iters", ITERS)
@pytest.mark.parametrize("ksize", KSIZES)
@pytest.mark.parametrize("width", WIDTHS)
def test_seg_head_kernel_matches_plain(cuda_device, width, ksize, iters):
    h = 150 if width > 100 else 70
    dx, dy, ib = head_inputs(8, h, width, seed=width + 10 * ksize + iters)
    got = _on_card(cuda_device, dx, dy, ib, TH * TH, ellipse_se(ksize, ksize), iters)
    assert got.any() and not got.all()
    assert not got[7].any()  # the inactive sample


@pytest.mark.cuda
@pytest.mark.parametrize("width", (33, 801))
def test_seg_head_kernel_threshold_ulps(cuda_device, width):
    """No iteration: the mask is the threshold; the float32 SEG_TH² itself
    is not above it, one ulp up is."""
    dx, dy, ib = head_inputs(2, 6, width, seed=width)
    ib[:] = True
    got = _on_card(cuda_device, dx, dy, ib, TH * TH, ellipse_se(3, 3), 0).cpu()
    first = got[:, 0, ::8]
    assert first[:, 0::3].eq(0).all() and first[:, 1::3].eq(0).all()
    assert first[:, 2::3].eq(255).all()
    for iters in (1, 5):
        _on_card(cuda_device, dx, dy, ib, TH * TH, ellipse_se(10, 10), iters)


@pytest.mark.cuda
@pytest.mark.parametrize("width", (65, tmf.SEG_HEAD_MAX_WIDTH))
def test_seg_head_kernel_widest_se(cuda_device, width):
    """SE 31 × 31 (reach 15): at 8,192 columns the tile takes opted-in
    shared memory."""
    dx, dy, ib = head_inputs(2, 40, width, seed=31)
    _on_card(cuda_device, dx, dy, ib, TH * TH, ellipse_se(31, 31), 2)


@pytest.mark.cuda
def test_seg_head_window_batch_interleaved_flow(cuda_device):
    """``seg_head_window_batch`` passes the ``[B, h, w, 2]`` flow's planes at
    element stride 2: one launch, equal to the plain version."""
    from nsof_tpu_torch.config import DATASETS

    cfg = DATASETS["grasp"]
    dx, dy, ib = head_inputs(8, 90, 801, seed=7, th=cfg.head.seg_th)
    flow = torch.stack([dx, dy], dim=-1).to(cuda_device)
    ib = ib.to(cuda_device)
    _build.reset_launches()
    got = tseg.seg_head_window_batch(flow, ib, cfg)
    torch.cuda.synchronize()
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {"seg_head": 1}
    se = ellipse_se(cfg.head.morph_ksize, cfg.head.morph_ksize)
    want = tmf.seg_head_plain(flow[..., 0], flow[..., 1], ib, cfg.head.seg_th ** 2, se,
                              cfg.head.morph_iters)
    assert torch.equal(got, want) and got.any()
