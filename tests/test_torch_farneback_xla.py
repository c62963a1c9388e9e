"""``kernel_mode='xla'`` end to end against the JAX package's.

The route without kernels: K7's plain version for the update and the
``_box_sum_dw`` box sum for the solve, as ``update_matrices_fast`` and
``update_flow_blur_fast`` run it in XLA.  Inputs: 96×128 frames of a
texture shifted by (dx, dy) = (+1, −2) px, made with numpy from a seed, uav
preset (poly_n 10, winsize 3), warp radius 3, B = 8.

Measured here: flow max 5.9e-3 px, mean 1.1e-6 px.  Winsize 3 leaves some
2×2 systems near the frame's edges ill-conditioned; f32 rounding
differences of a few ulp (XLA's convolution order against the port's slice
sums) grow there over 3 levels × 3 iterations.
"""

import jax.numpy as jnp
import numpy as np

from nsof_tpu.ops import farneback_fast as jff
from nsof_tpu.ops.farneback import PRESETS as JAX_PRESETS
from nsof_tpu_torch.ops import farneback_fast as tff
from nsof_tpu_torch.ops.farneback import PRESETS

RADIUS = 3


def test_xla_route_matches_jax():
    """Flow ≤ 1e-2 px max, ≤ 1e-5 px mean."""
    b, h, w = 8, 96, 128
    rng = np.random.default_rng(0)
    base = rng.random((h + 64, w + 64)).astype(np.float32) * 255
    prev = np.stack([base[16 + v % 5 : 16 + v % 5 + h, 16 : 16 + w]
                     for v in range(b)]).astype(np.uint8)
    nxt = np.stack([base[18 + v % 5 : 18 + v % 5 + h, 15 : 15 + w]
                    for v in range(b)]).astype(np.uint8)
    got = tff.farneback_fast(prev, nxt, PRESETS["uav"], RADIUS, "xla",
                             device="cpu").numpy()
    ref = np.asarray(jff.farneback_fast(jnp.asarray(prev), jnp.asarray(nxt),
                                        JAX_PRESETS["uav"], RADIUS, "xla"))
    assert got.shape == ref.shape == (b, h, w, 2)
    err = np.abs(got - ref)
    assert err.max() <= 1e-2
    assert err.mean() <= 1e-5
