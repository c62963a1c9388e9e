"""K1 (window crop), K2 (polynomial expansion), K3/K5 (separable warp +
system build), K4 (fused box-solve + warp + rebuild) and K7 (four-tap warp
+ system build) on the card against their plain versions, exactly.

The cases are ``chip_smoke.py``'s, which checks them in its own run too.
K1: source origins ≡ 0, 1 and 15 (mod 16), window widths that are not a
multiple of 16, 1-, 2-, 4- and 12-byte elements (uint8, bf16, f32 and f32
with three trailing channels), negative and clamped origins, B = 1.  K2:
n 1, 5, 7 and 10 (poly_sigma 1.05), with and without the 3-tap blur, margins (0, 0) and (8, 16),
canvases larger than the image, ragged strips and runs, B = 1.  K3: both M
types at radius 3, 5 and 7 on a canvas with slack rows and columns; K5 at
radius 3, 8 and its widest on a 97×131 level.  K4: both emits and both M
types at the grasp (15, 3), tabletennis (4, 5), fused-route limit (17, 7)
and widest (63, 7) (winsize, radius), on ``K4_SHAPES``: a canvas with slack
rows and columns, walks across 5 row blocks of a width no strip divides,
grasp's coarsest level, tabletennis's 160×160, and the tile design forced;
the wrapper's strip plan against the kernel's own.  K7: radius 1, 3, 8 and 37 on a 97×131 level, B = 2 and 1, with
flows at integers, ±r and beyond, ±0, tiny values and one ulp either side
of each integer.  K8 (the device scan): the 6×8, 12×16 and a ragged 7×13
grid, the modulation's dead zone and powf drives, mixed lanes (cells that
clamp to 0 or 1 early beside cells that run whole pairs), w0 at exact 0, 1
and -0.0, a NaN w0 and a 24×32 grid (lanes packed), at n_substeps 1000 (the
final state, the gray maps and the per-pair states, compared by their
bits).  K9 (batched NMS): YOLO's 300 candidates at B = 1 and 8, N = 1, no
and every candidate, equal scores, the class offset, inclusive widths,
zero-area boxes, NaN inputs, valid -inf scores (the kernel's greedy loop),
N = 1024, the first N whose suppression mask leaves shared memory, a row
wider than a block and one whose whole arena leaves shared memory (N =
8,192) (the keep masks).

Needs the card: ``python -m pytest --noconftest -m cuda
tests/test_torch_kernels_cuda.py`` (the card's machine has no jax, which
the repo's conftest imports).  Skipped without a CUDA device.
"""

import ctypes

import numpy as np
import pytest
import torch

from chip_smoke import (K1_CASES, K2_CASES, K3_CASES, K4_CASES, K7_CASES, K8_CASES, K9_CASES,
                        bits_equal, k2_case, k3_case, k7_case, k8_case, k9_case)
from nsof_tpu_torch import _build
from nsof_tpu_torch.ops import farneback_fast as tff
from nsof_tpu_torch.ops import roi as troi


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(K1_CASES))
def test_crop_windows_kernel_matches_plain(cuda_device, name):
    shape, dtype, (wh, ww), oys, oxs = K1_CASES[name]
    rng = np.random.default_rng(len(name))
    if dtype == torch.uint8:
        frames = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))
    else:
        frames = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
    frames = frames.to(cuda_device)
    oy = torch.tensor(oys, dtype=torch.int32, device=cuda_device)
    ox = torch.tensor(oxs, dtype=torch.int32, device=cuda_device)
    got = troi.crop_windows_batch(frames, oy, ox, wh, ww)
    torch.cuda.synchronize()
    ref = troi.crop_windows(frames, oy, ox, wh, ww)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert torch.equal(got, ref)


# K4's canvases: name → (B, hk, wk, hp, wp, SM count the plan is picked for
# (None: the card's), design).  "walk_ragged": one SM's block slots make
# walks as long as the picker allows, at least 4 of the 8 row blocks, and
# 200 columns are no multiple of the 32-column strip; "grasp_level2": grasp's coarsest canvas; "tabletennis": 160×160,
# 5 strips (fewer than the SMs); "tile": the tile design, forced.
K4_SHAPES = {
    "64x96": (3, 40, 50, 64, 96, None, "auto"),
    "walk_ragged": (2, 250, 190, 256, 200, 1, "auto"),
    "grasp_level2": (2, 270, 480, 288, 480, None, "auto"),
    "tabletennis": (2, 160, 160, 160, 160, None, "auto"),
    "tile": (3, 40, 50, 64, 96, None, "tile"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(K4_SHAPES))
@pytest.mark.parametrize("m_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("emit", ["matrices", "flow"])
@pytest.mark.parametrize("winsize,radius", K4_CASES)
def test_fused_box_update_kernel_matches_plain(cuda_device, winsize, radius, emit, m_dtype,
                                               shape):
    """Max |Δ| 0 on both designs: the kernel is built with --fmad=false and
    sums in the plain version's order."""
    rng = np.random.default_rng(winsize * 10 + radius)
    b, hk, wk, hp, wp, n_sm, design = K4_SHAPES[shape]
    mr, mc = tff.R1_MARGIN

    def t(shape, scale):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32) * scale).to(cuda_device)

    m = t((b, 5, hp, wp), 100.0).to(m_dtype)
    r0 = t((b, 5, hp, wp), 50.0)
    r1 = t((b, 5, hp + 2 * mr, wp + 2 * mc), 50.0)
    bsc = tff.border_scale(hk, wk, str(cuda_device))
    if design == "tile":
        plan = tff.K4_TILE_PLAN
    else:
        plan = tff.k4_plan(winsize, radius, emit, m_dtype, hp, wp, b,
                           n_sm or tff._sm_count(cuda_device.index or 0))
    if shape == "walk_ragged" and plan.walk:
        assert plan.walk >= 4
    _build.reset_launches()
    got = tff._fused_box_update_cuda(m, r0, r1, bsc, winsize, radius, emit, tff.R1_MARGIN,
                                     plan=plan)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fused_box_update_strip" if plan.walk else
                           "fused_box_update_tile"] == 1
    ref = tff._fused_box_update_plain(m, r0, r1, bsc, winsize, radius, emit)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert (got.float() - ref.float()).abs().max().item() == 0


@pytest.mark.cuda
def test_fused_box_update_strip_bytes_match_the_kernel(cuda_device):
    """The wrapper's mirror of the strip design's shared memory is the
    kernel's own plan, byte for byte."""
    fn = _build.load("fused_box_update").nsof_fused_box_update_strip_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 4, ctypes.c_int
    for winsize in (4, 5, 14, 15):
        for radius in tff.K4_STRIP_RADII:
            for flow in (0, 1):
                for m_bytes in (2, 4):
                    want = tff._k4_strip_layout(winsize, radius, bool(flow), m_bytes)
                    assert fn(winsize, radius, flow, m_bytes) == want["bytes"]
    assert fn(17, 3, 0, 2) == fn(15, 7, 0, 2) == -1


def _assert_exact(got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert (got.float() - ref.float()).abs().max().item() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(K2_CASES))
def test_poly_expansion_kernel_matches_plain(cuda_device, name):
    kernel, plain = k2_case(name, cuda_device)
    got = kernel()
    torch.cuda.synchronize()
    _assert_exact(got, plain())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(K3_CASES))
def test_update_matrices_sep_kernel_matches_plain(cuda_device, name):
    kernel, plain = k3_case(name, cuda_device)
    got = kernel()
    torch.cuda.synchronize()
    _assert_exact(got, plain())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(K7_CASES))
def test_update_matrices_kernel_matches_plain(cuda_device, name):
    kernel, plain = k7_case(name, cuda_device)
    got = kernel()
    torch.cuda.synchronize()
    _assert_exact(got, plain())


@pytest.mark.cuda
def test_update_matrices_sep_refuses_wider_radius(cuda_device):
    """Past its widest radius the K5 launcher refuses and the wrapper
    raises; nothing falls back to the plain version."""
    r = tff.SEP_MAX_RADIUS + 1
    b, h, w = 1, 40, 50
    z = torch.zeros((b, h, w), device=cuda_device)
    r0 = torch.zeros((b, 5, h, w), device=cuda_device)
    r1p = torch.zeros((b, 5, h + 2 * r + 2, w + 2 * r + 2), device=cuda_device)
    with pytest.raises(RuntimeError, match="failed to launch"):
        tff.update_matrices(z, z, r0, r1p, tff.border_scale(h, w, str(cuda_device)), r,
                            separable=True)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(K8_CASES))
def test_device_scan_kernel_matches_plain(cuda_device, name):
    kernel, plain = k8_case(name, cuda_device)
    for got, ref in zip(kernel(), plain()):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert bits_equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(K9_CASES))
def test_nms_kernel_matches_plain(cuda_device, name):
    kernel, plain = k9_case(name, cuda_device)
    got, ref = kernel(), plain()
    assert got.dtype == torch.bool and got.shape == ref.shape
    assert torch.equal(got, ref)
