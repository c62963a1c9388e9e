"""The port's batched ROI gate (components, boxes, crop K1's plain version,
window mask, scatter, region percentage) against the vmapped JAX versions:
all exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsof_tpu.ops import components as jcc
from nsof_tpu.ops import roi as jroi
from nsof_tpu_torch.ops import components as tcc
from nsof_tpu_torch.ops import roi as troi

H, W = 480, 640


def _grids(seed: int, gh: int = 6, gw: int = 8) -> np.ndarray:
    """Random uint8 state maps plus the edge cases, [B, gh, gw]."""
    rng = np.random.default_rng(seed)
    grids = [
        np.zeros((gh, gw), np.uint8),  # no active cell
        np.full((gh, gw), 255, np.uint8),  # saturated
        # checkerboard: gh·gw/2 = 24 one-cell components > k_max = 16
        ((np.indices((gh, gw)).sum(0) % 2) * 255).astype(np.uint8),
        np.zeros((gh, gw), np.uint8),
    ]
    grids[3][1, 1] = grids[3][2, 2] = 255  # diagonal-only pair
    for p in (0.1, 0.3, 0.5, 0.7):
        for _ in range(3):
            grids.append((rng.random((gh, gw)) < p).astype(np.uint8) * 255)
    # values around the threshold
    grids.append(rng.integers(240, 256, (gh, gw)).astype(np.uint8))
    return np.stack(grids)


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("shape", [(6, 8), (16, 24)])
def test_components_match_jax(connectivity, shape):
    masks = _grids(1, *shape) > 0
    ref_l = np.stack([np.asarray(jcc.label_components(jnp.asarray(m), connectivity))
                      for m in masks])
    got_l = tcc.label_components(torch.from_numpy(masks), connectivity).numpy()
    np.testing.assert_array_equal(got_l, ref_l)
    ref = jax.vmap(lambda lab: jcc.component_stats(lab, 16))(jnp.asarray(ref_l))
    got = tcc.component_stats(torch.from_numpy(got_l), 16)
    for key in ("boxes", "areas", "valid", "count"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]), key)


@pytest.mark.parametrize("memsize,connectivity", [(80, 4), (80, 8), (60, 4)])
def test_roi_boxes_match_jax(memsize, connectivity):
    cfg = jroi.RoiConfig(memsize=memsize, connectivity=connectivity)
    tcfg = troi.RoiConfig(memsize=memsize, connectivity=connectivity)
    mem = _grids(2)
    ref = jax.vmap(lambda m: jroi.roi_boxes(m, H, W, cfg))(jnp.asarray(mem))
    got = troi.roi_boxes(torch.from_numpy(mem), H, W, tcfg)
    for key in ("boxes", "valid", "merged", "any_active", "transition", "labels"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]), key)
    assert not got["any_active"][0] and got["any_active"][1]


def _windows_case(seed):
    rng = np.random.default_rng(seed)
    mem = _grids(seed)
    b = mem.shape[0]
    cfg = jroi.RoiConfig()
    boxes = np.array(
        jax.vmap(lambda m: jroi.roi_boxes(m, H, W, cfg))(jnp.asarray(mem))["merged"]
    )
    frames = rng.integers(0, 256, (b, H, W)).astype(np.uint8)
    return boxes, frames


@pytest.mark.parametrize("win", [(256, 384), (200, 301), (480, 640)])
def test_window_crop_mask_scatter_match_jax(win):
    wh, ww = win
    boxes, frames = _windows_case(3)
    jo = jax.vmap(lambda bx: jroi.window_origin(bx, wh, ww, H, W))(jnp.asarray(boxes))
    oys, oxs = troi.window_origin(torch.from_numpy(boxes), wh, ww, H, W)
    np.testing.assert_array_equal(oys.numpy(), np.asarray(jo[0]))
    np.testing.assert_array_equal(oxs.numpy(), np.asarray(jo[1]))

    ref_w, _, _ = jroi.crop_windows_batch(jnp.asarray(frames), jo[0], jo[1], wh, ww)
    got_w = troi.crop_windows_batch(torch.from_numpy(frames), oys, oxs, wh, ww)
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(ref_w))

    ref_m = jax.vmap(lambda bx, oy, ox: jroi.window_box_mask(bx, (oy, ox), wh, ww))(
        jnp.asarray(boxes), jo[0], jo[1])
    got_m = troi.window_box_mask(torch.from_numpy(boxes), oys, oxs, wh, ww)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(ref_m))

    # scatter of a uint8 window and of a 2-channel float window
    b = frames.shape[0]
    rng = np.random.default_rng(4)
    win2 = rng.normal(size=(b, wh, ww, 2)).astype(np.float32)
    full2 = rng.normal(size=(b, H, W, 2)).astype(np.float32)
    for full, window in ((np.zeros((b, H, W), np.uint8), np.asarray(ref_w)),
                         (full2, win2)):
        ref_s = jax.vmap(lambda f, wv, bx, oy, ox: jroi.scatter_window(
            f, wv, bx, (oy, ox)))(jnp.asarray(full), jnp.asarray(window),
                                  jnp.asarray(boxes), jo[0], jo[1])
        got_s = troi.scatter_window(torch.from_numpy(full), torch.from_numpy(window),
                                    torch.from_numpy(boxes), oys, oxs)
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))


def test_crop_clamps_origins_like_dynamic_slice():
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 256, (6, 40, 50)).astype(np.uint8)
    oys = np.array([-5, 0, 3, 30, 39, 100], np.int32)
    oxs = np.array([-1, 49, 7, 0, 25, 12], np.int32)
    ref, _, _ = jroi.crop_windows_batch(jnp.asarray(frames), jnp.asarray(oys),
                                        jnp.asarray(oxs), 16, 24)
    got = troi.crop_windows_batch(torch.from_numpy(frames), torch.from_numpy(oys),
                                  torch.from_numpy(oxs), 16, 24)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    for i in range(len(frames)):  # the single-image crop, same semantics
        one = jroi.crop_window(jnp.asarray(frames[i]), (oys[i], oxs[i]), 16, 24)
        np.testing.assert_array_equal(
            troi.crop_window(torch.from_numpy(frames[i]), (int(oys[i]), int(oxs[i])),
                             16, 24).numpy(), np.asarray(one))


@pytest.mark.parametrize("hw", [(480, 640), (240, 320), (161, 161)])
def test_region_percentage_matches_jax(hw):
    h, w = hw
    rng = np.random.default_rng(6)
    x0 = rng.integers(-10, w, 500)
    y0 = rng.integers(-10, h, 500)
    boxes = np.stack([x0, y0, x0 + rng.integers(-5, w, 500),
                      y0 + rng.integers(-5, h, 500)], -1).astype(np.int32)
    # the JAX function as written (not as XLA rewrites it under jit; see
    # tests/test_torch_segmentation.py)
    ref = jax.vmap(lambda bx: jroi.region_percentage(bx, h, w))(jnp.asarray(boxes))
    got = troi.region_percentage(torch.from_numpy(boxes), h, w)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
