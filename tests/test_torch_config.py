"""The PyTorch port's configuration and numpy-only coefficient helpers
against the JAX package's: equal field by field and value by value."""

import dataclasses

import numpy as np
import pytest

from nsof_tpu import config as jcfg
from nsof_tpu.ops import farneback as jfb
from nsof_tpu.ops import morphology as jmorph
from nsof_tpu_torch import config as tcfg
from nsof_tpu_torch.ops import farneback as tfb
from nsof_tpu_torch.ops import morphology as tmorph


def _bench_cfg():
    """bench.py's overrides of the grasp preset (bench.py:49-64)."""
    cfg = dataclasses.replace(
        jcfg.DATASETS["grasp"], name="bench640", image_h=480, image_w=640,
        window_h=256, window_w=384, warp_radius=3,
    )
    return dataclasses.replace(
        cfg, roi=dataclasses.replace(cfg.roi, memsize=80)
    )


@pytest.mark.parametrize("name", sorted(jcfg.DATASETS) + ["bench640"])
def test_config_from_dict_round_trips(name):
    ref = _bench_cfg() if name == "bench640" else jcfg.DATASETS[name]
    got = tcfg.config_from_dict(dataclasses.asdict(ref))
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.win_shape == ref.win_shape
    assert got.sep_win_shape == ref.sep_win_shape
    if name != "bench640":
        # the port's own presets are the same values
        assert dataclasses.asdict(tcfg.DATASETS[name]) == dataclasses.asdict(ref)


def test_presets_and_border_table_equal():
    assert {k: dataclasses.asdict(v) for k, v in tfb.PRESETS.items()} == {
        k: dataclasses.asdict(v) for k, v in jfb.PRESETS.items()
    }
    np.testing.assert_array_equal(tfb._BORDER_TABLE, jfb._BORDER_TABLE)
    assert tfb._BORDER == jfb._BORDER


@pytest.mark.parametrize("n,sigma", [(1, 1.05), (5, 1.2), (5, 1.1), (7, 1.5),
                                     (10, 1.05), (3, 0.0)])
def test_poly_exp_coeffs_equal(n, sigma):
    ref = jfb._poly_exp_coeffs(n, sigma)
    got = tfb._poly_exp_coeffs(n, sigma)
    for a, b in zip(ref[:3], got[:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # the inverse-moment scalars: same float64 computation, tolerance 1e-12
    np.testing.assert_allclose(got[3:], ref[3:], rtol=0, atol=1e-12)


@pytest.mark.parametrize("rows", range(3, 16))
def test_ellipse_se_equal(rows):
    for cols in range(3, 16):
        np.testing.assert_array_equal(
            tmorph.ellipse_se(rows, cols), jmorph.ellipse_se(rows, cols)
        )


def test_scalar_helpers_equal():
    for v in np.concatenate([np.arange(-4, 4, 0.25), np.linspace(0, 700, 211),
                             [0.5, 1.5, 2.5, 255.5, 1e-9]]):
        assert tfb._cv_round(float(v)) == jfb._cv_round(float(v))
    for ksize in (1, 3, 5, 7, 9, 11):
        for sigma in (0.0, -1.0, 0.3, 0.5, 1.0, 1.5, 2.7):
            np.testing.assert_array_equal(
                tfb._gaussian_blur_kernel(ksize, sigma),
                jfb._gaussian_blur_kernel(ksize, sigma),
            )
    for h in (16, 31, 32, 64, 100, 128, 256, 480):
        for w in (16, 40, 64, 161, 384, 640):
            for levels in (0, 1, 3, 5):
                for scale in (0.5, 0.6, 0.8):
                    assert tfb._effective_levels(h, w, levels, scale) == \
                        jfb._effective_levels(h, w, levels, scale)
