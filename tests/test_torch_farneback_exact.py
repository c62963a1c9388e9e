"""The port's exact Farnebäck path against the JAX package's and OpenCV's.

``nsof_tpu_torch.ops.farneback.farneback_batch(..., device='cpu')`` against
``nsof_tpu.ops.farneback.farneback`` (plain XLA, jitted) on each pair, at
120×160 for the grasp, tabletennis and autodriving presets: a blurred
random texture moved by (−1.7, +2.4) px with cv2.warpAffine, made from a
seed, B = 2 (the pair and its reverse).  Then against cv2 with
``tests/test_farneback.py``'s interior bounds (grasp), and the port's fast
route (``'xla'``) against the port's exact path with
``tests/test_fast_path.py``'s bounds.

Measured here (5 tests): flow against JAX max 6.4e-6 / 7.8e-5 / 7.1e-5 px
and mean 4.8e-7 / 2.4e-6 / 2.9e-6 px (grasp / tabletennis / autodriving);
interior EPE against cv2 mean 4.1e-4 px, max 5.2e-2 px (the JAX path's:
4.1e-4, 5.2e-2); fast 'xla' route against the exact path mean EPE 1.6e-3
px, median 6.4e-7 px.
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsof_tpu.ops import farneback as jfb
from nsof_tpu_torch.ops import farneback as tfb
from nsof_tpu_torch.ops import farneback_fast as tff


def _pair(seed, h=120, w=160, dx=-1.7, dy=2.4):
    """tests/test_farneback.py's synthetic pair."""
    rng = np.random.default_rng(seed)
    base = cv2.GaussianBlur(
        (rng.random((h + 40, w + 40)) * 255).astype(np.float32), (0, 0), 2.5
    )
    img0 = base[20 : 20 + h, 20 : 20 + w].astype(np.uint8)
    m = np.float32([[1, 0, dx], [0, 1, dy]])
    img1 = cv2.warpAffine(base, m, base.shape[::-1])[20 : 20 + h, 20 : 20 + w]
    return img0, img1.astype(np.uint8)


@pytest.mark.parametrize("preset", ["grasp", "tabletennis", "autodriving"])
def test_exact_flow_matches_jax(preset):
    """Flow ≤ 1e-2 px max, ≤ 5e-4 px mean against the JAX ``farneback``."""
    img0, img1 = _pair(1)
    prev, nxt = np.stack([img0, img1]), np.stack([img1, img0])
    got = tfb.farneback_batch(prev, nxt, tfb.PRESETS[preset], device="cpu").numpy()
    ref = np.stack([np.asarray(jfb.farneback(jnp.asarray(a), jnp.asarray(b),
                                             jfb.PRESETS[preset]))
                    for a, b in zip(prev, nxt)])
    assert got.shape == ref.shape == (2, 120, 160, 2) and got.dtype == np.float32
    err = np.abs(got - ref)
    assert err.max() <= 1e-2, err.max()
    assert err.mean() <= 5e-4, err.mean()
    one = tfb.farneback(img0, img1, tfb.PRESETS[preset], device="cpu").numpy()
    np.testing.assert_array_equal(one, got[0])


def test_exact_interior_matches_cv2():
    """tests/test_farneback.py::test_headline_preset_interior_is_exact's
    bounds: interior EPE mean < 5e-3 px, max < 0.3 px (grasp), and the
    known translation recovered to 0.5 px."""
    p = tfb.PRESETS["grasp"]
    img0, img1 = _pair(2)
    ref = cv2.calcOpticalFlowFarneback(img0, img1, None, p.pyr_scale, p.levels,
                                       p.winsize, p.iterations, p.poly_n,
                                       p.poly_sigma, 0)
    ours = tfb.farneback(img0, img1, p, device="cpu").numpy()
    err = np.linalg.norm(ours - ref, axis=-1)
    band = 32
    assert err[:-band, :-band].mean() < 5e-3
    assert err[:-band, :-band].max() < 0.3
    img0, img1 = _pair(3, dx=-2.0, dy=1.0)
    inner = tfb.farneback(img0, img1, p, device="cpu").numpy()[30:-30, 30:-30]
    assert inner[..., 0].mean() == pytest.approx(-2.0, abs=0.5)
    assert inner[..., 1].mean() == pytest.approx(1.0, abs=0.5)


def test_fast_xla_route_matches_exact():
    """tests/test_fast_path.py::test_fast_matches_exact_for_small_flows's
    bounds: mean EPE < 0.05 px, median < 0.02 px, 96×128, radius 4."""
    p = tfb.FarnebackParams(0.5, 2, 9, 2, 5, 1.1)
    img0, img1 = _pair(4, h=96, w=128)
    prev = torch.from_numpy(np.stack([img0] * 2))
    nxt = torch.from_numpy(np.stack([img1] * 2))
    exact = tfb.farneback_batch(prev, nxt, p, device="cpu")
    fast = tff.farneback_fast(prev, nxt, p, 4, "xla", device="cpu")
    err = np.linalg.norm((fast - exact).numpy(), axis=-1)
    assert err.mean() < 0.05
    assert np.median(err) < 0.02
