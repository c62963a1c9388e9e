"""The port's unpacked boolean morphology against the JAX package's
bit-packed ``dilate_erode_n_masked_hwb``: bit-exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsof_tpu.ops import morphology as jmorph
from nsof_tpu.ops import morphology_fast as jmf
from nsof_tpu_torch.ops import morphology as tmorph
from nsof_tpu_torch.ops import morphology_fast as tmf


def test_se_row_runs_equal():
    for k in range(3, 16):
        se = tmorph.ellipse_se(k, k)
        assert tmf.se_row_runs(se) == jmf.se_row_runs(jmorph.ellipse_se(k, k))


@pytest.mark.parametrize("ksize,iters", [(10, 5), (3, 2), (7, 1)])
@pytest.mark.parametrize("width", [50, 101])
def test_dilate_erode_n_masked_bit_exact(width, ksize, iters):
    rng = np.random.default_rng(width + ksize)
    b, h = 6, 37
    mask = rng.random((b, h, width)) < 0.3
    # inbox: a random box per sample, one full window and one random field
    inbox = np.zeros((b, h, width), bool)
    for i in range(b - 2):
        y0, x0 = rng.integers(0, h // 2), rng.integers(0, width // 2)
        inbox[i, y0 : y0 + rng.integers(5, h), x0 : x0 + rng.integers(5, width)] = True
    inbox[b - 2] = True
    inbox[b - 1] = rng.random((h, width)) < 0.8
    se = jmorph.ellipse_se(ksize, ksize)
    ref = np.asarray(jmf.dilate_erode_n_masked_hwb(
        jnp.asarray(mask.transpose(1, 2, 0)), jnp.asarray(inbox.transpose(1, 2, 0)),
        se, iters)).transpose(2, 0, 1)
    got = tmf.dilate_erode_n_masked(torch.from_numpy(mask), torch.from_numpy(inbox),
                                    tmorph.ellipse_se(ksize, ksize), iters)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref.any() and not ref.all()
