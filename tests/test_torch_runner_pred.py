"""``run_prediction`` of the port (``device='cpu'``) against the JAX
package's on ``torch_runner_scene``'s synthetic scene (tabletennis cut to
96×128, memsize 16, 6 frames of a moving box): the predicted frames of both
paths, the SSIMs within 1e-5, the CSV's header and every column that holds
no time equal (the SSIM columns within one unit of their 4th decimal), the
timing summary's keys alike.

Measured on the CPU: SSIMs within 3.1e-6; the full-frame predictions within
one level (99.997 % equal); the ROI predictions 99.946 % equal and 99.974 %
within one level: on pair 0 one ill-conditioned pixel of the exact
Farnebäck on the 64×96 window (a flow of 11 px) differs by 0.15 px from the
JAX function's (ROADMAP queue 3), which moves 39 of the pair's values by up
to 11 levels.  Fed the same flows, the prediction stages are equal bit for
bit (``tests/test_torch_prediction.py``)."""

import numpy as np
import pytest

from nsof_tpu.pipelines import runner as jrunner
from nsof_tpu_torch.pipelines import runner as trunner
from nsof_tpu_torch.utils.reporting import PRED_COLUMNS
from torch_runner_scene import assert_csv_values_equal, assert_timing_keys, read_csv, scenes
from torch_single_thread import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("runner_pred")
    jscene, tscene = scenes()
    ref = jrunner.run_prediction(jscene, out / "jax.csv", out / "jax.txt")
    got = trunner.run_prediction(tscene, out / "torch.csv", out / "torch.txt", device="cpu")
    return out, got, ref


@pytest.mark.parametrize("key,within_one", [("preds_full", 0.9999), ("preds", 0.999)])
def test_predictions(runs, key, within_one):
    _, got, ref = runs
    g, r = getattr(got, key), np.asarray(getattr(ref, key))
    assert g.shape == r.shape == (4, 96, 128, 3) and g.dtype == r.dtype == np.uint8
    diff = np.abs(g.astype(np.int64) - r.astype(np.int64))
    assert (diff <= 1).mean() >= within_one, (key, (diff <= 1).mean())
    assert (diff == 0).mean() >= 0.999, (key, (diff == 0).mean())


def test_metrics(runs):
    _, got, ref = runs
    assert set(got.metrics) == set(ref.metrics) == {"mean_ssim", "mean_ssim_full"}
    for k in ref.metrics:
        assert abs(got.metrics[k] - ref.metrics[k]) <= 1e-5, k
    assert_timing_keys(got.timing, ref.timing)


def test_csv(runs):
    out, *_ = runs
    head, rows = read_csv(out / "torch.csv")
    assert head == PRED_COLUMNS and len(rows) == 4
    assert_csv_values_equal(out / "torch.csv", out / "jax.csv")
