"""``run_tracking`` of the port (``device='cpu'``) against the JAX package's
on ``torch_runner_scene``'s synthetic scene (tabletennis cut to 96×128,
memsize 16, 6 frames of a moving box, a GT mask): the ROI and full-frame
boxes and valid flags equal, the IoUs against the GT max box equal, the
CSV's header and every column that holds no time equal, the timing
summary's keys alike.  Measured on the CPU: all equal, one valid box a
pair on each path."""

import numpy as np
import pytest

from nsof_tpu.pipelines import runner as jrunner
from nsof_tpu_torch.pipelines import runner as trunner
from nsof_tpu_torch.utils.reporting import OB_COLUMNS
from torch_runner_scene import assert_csv_values_equal, assert_timing_keys, read_csv, scenes
from torch_single_thread import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("runner_track")
    jscene, tscene = scenes()
    ref = jrunner.run_tracking(jscene, out / "jax.csv", out / "jax.txt")
    got = trunner.run_tracking(tscene, out / "torch.csv", out / "torch.txt", device="cpu")
    return out, got, ref


def test_boxes(runs):
    _, got, ref = runs
    for key in ("boxes", "boxes_valid", "boxes_full", "boxes_full_valid"):
        g, r = getattr(got, key), np.asarray(getattr(ref, key))
        assert g.dtype == r.dtype, key
        np.testing.assert_array_equal(g, r, key)
    assert got.boxes_valid.any(1).all(), "a pair found no box"


def test_metrics(runs):
    _, got, ref = runs
    assert got.metrics == ref.metrics and set(ref.metrics) == {"mean_iou", "mean_iou_full"}
    assert_timing_keys(got.timing, ref.timing)


def test_csv(runs):
    out, *_ = runs
    head, rows = read_csv(out / "torch.csv")
    assert head == OB_COLUMNS and len(rows) == 4
    assert all(r["Combination_Time"] == "0.0000" for r in rows)
    assert_csv_values_equal(out / "torch.csv", out / "jax.csv")
