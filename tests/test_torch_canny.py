"""The port's Canny gate (``ops/canny.py``) against the JAX package's.

``tests/test_canny.py``'s synthetic transition grids (random blocky
binary grids at three densities and sizes, a box, an L shape, two blobs),
plus a ring with a nested component, made with numpy from a seed.
``canny_edges``, ``canny_roi_boxes`` (``device='cpu'``) and
``transition_from_mem`` against the JAX functions: equal, bit for bit (the
inputs are integers, every sum exact).  The two loops that are
``lax.while_loop`` s in JAX read their flag on the host once every
``CHECK_EVERY`` steps and stop at the first read that finds no change.
"""

import numpy as np
import pytest
import torch

from nsof_tpu.ops import canny as jcanny
from nsof_tpu_torch.ops import canny as tcanny


def _grids():
    rng = np.random.default_rng(3)
    out = []
    for shape in [(16, 16), (24, 13), (15, 15)]:
        for density in (0.1, 0.3, 0.6):
            out.append((rng.random(shape) < density).astype(np.uint8) * 255)
    g = np.zeros((20, 20), np.uint8)
    g[4:9, 5:12] = 255
    out.append(g)
    g = np.zeros((20, 20), np.uint8)
    g[3:15, 3:6] = 255
    g[12:15, 3:14] = 255
    out.append(g)
    g = np.zeros((16, 24), np.uint8)
    g[2:6, 2:7] = 255
    g[9:14, 15:21] = 255
    out.append(g)
    g = np.zeros((24, 24), np.uint8)  # a ring around a nested block
    g[2:22, 2:22] = 255
    g[5:19, 5:19] = 0
    g[10:14, 10:14] = 255
    out.append(g)
    return out


GRIDS = _grids()


@pytest.mark.parametrize("i", range(len(GRIDS)))
def test_canny_edges_match_jax(i):
    g = GRIDS[i]
    ref = np.asarray(jcanny.canny_edges(g.astype(np.float32)))
    got = tcanny.canny_edges(g.astype(np.float32), device="cpu").numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("k_max", [8, 32])
def test_canny_roi_boxes_match_jax(k_max):
    cell = 10
    for g in GRIDS:
        gh, gw = g.shape
        ref = jcanny.canny_roi_boxes(g, gh * cell, gw * cell, cell, cell, k_max=k_max)
        got = tcanny.canny_roi_boxes(g, gh * cell, gw * cell, cell, cell, k_max=k_max,
                                     device="cpu")
        for key in ("valid", "any_active", "edges"):
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]), err_msg=key)
        valid = got["valid"].numpy()
        np.testing.assert_array_equal(got["boxes"].numpy()[valid],
                                      np.asarray(ref["boxes"])[valid])


def test_transition_from_mem_matches_jax():
    rng = np.random.default_rng(5)
    mem = np.full((40, 60), 255, np.uint8)
    mem[10:20, 30:40] = 100
    mem[rng.random((40, 60)) < 0.1] = 254
    for args in ((4, 6, 10, 10), (3, 5, 13, 11)):
        np.testing.assert_array_equal(tcanny.transition_from_mem(mem, *args).numpy(),
                                      np.asarray(jcanny.transition_from_mem(mem, *args)))


def test_fixpoint_checks_every_few_steps():
    """The loop that replaces a ``while_loop`` runs CHECK_EVERY steps
    between host reads and stops at the first read that finds no change: a
    pixel grown along a 1×40 row fills it in 39 steps; steps 41–48 are the
    first block that changes nothing, so it stops after 48 (six reads),
    with the ``while_loop``'s result."""
    steps = []
    start = torch.zeros((1, 40), dtype=torch.bool)
    start[0, 0] = True

    def grow(cur):
        steps.append(1)
        return tcanny._grow(cur, [(0, -1)])

    out = tcanny._fixpoint(grow, start)
    assert out.all() and len(steps) == 6 * tcanny.CHECK_EVERY
