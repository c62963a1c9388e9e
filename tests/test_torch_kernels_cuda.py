"""K1 (window crop) and K4 (fused box-solve + warp + rebuild) on the card
against their plain versions, exactly.

The cases are ``chip_smoke.py``'s, which checks them in its own run too.
K1: source origins ≡ 0, 1 and 15 (mod 16), window widths that are not a
multiple of 16, 1-, 2-, 4- and 12-byte elements (uint8, bf16, f32 and f32
with three trailing channels), negative and clamped origins, B = 1.  K4:
both emits and both M types at the grasp (15, 3), tabletennis (4, 5),
fused-route limit (17, 7) and widest (63, 7) (winsize, radius), on a canvas
with slack rows and columns.

Needs the card: ``python -m pytest --noconftest -m cuda
tests/test_torch_kernels_cuda.py`` (the card's machine has no jax, which
the repo's conftest imports).  Skipped without a CUDA device.
"""

import numpy as np
import pytest
import torch

from chip_smoke import K1_CASES, K4_CASES
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
    ref = troi._crop_windows_plain(frames, oy, ox, wh, ww)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("m_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("emit", ["matrices", "flow"])
@pytest.mark.parametrize("winsize,radius", K4_CASES)
def test_fused_box_update_kernel_matches_plain(cuda_device, winsize, radius, emit, m_dtype):
    """Max |Δ| 0: the kernel is built with --fmad=false and sums in the
    plain version's order."""
    rng = np.random.default_rng(winsize * 10 + radius)
    b, hk, wk, hp, wp = 3, 40, 50, 64, 96
    mr, mc = tff.R1_MARGIN

    def t(shape, scale):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32) * scale).to(cuda_device)

    m = t((b, 5, hp, wp), 100.0).to(m_dtype)
    r0 = t((b, 5, hp, wp), 50.0)
    r1 = t((b, 5, hp + 2 * mr, wp + 2 * mc), 50.0)
    bsc = tff.border_scale(hk, wk, str(cuda_device))
    got = tff.fused_box_update(m, r0, r1, bsc, winsize, radius, emit)
    torch.cuda.synchronize()
    ref = tff._fused_box_update_plain(m, r0, r1, bsc, winsize, radius, emit)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert (got.float() - ref.float()).abs().max().item() == 0
