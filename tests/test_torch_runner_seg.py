"""``run_segmentation`` of the port (``device='cpu'``) against the JAX
package's on ``torch_runner_scene``'s synthetic scene (tabletennis cut to
96×128, memsize 16, 6 frames of a moving box, a GT mask): ROI and
full-frame masks ≥ 99.5 % equal, pixel accuracies within 1e-4, the CSV's
header and every column that holds no time equal (the PA columns within one
unit of their 4th decimal), the text log's lines and
the timing summary's keys alike.  Measured on the CPU: masks 100 % equal,
mean PAs within 8e-6."""

import numpy as np
import pytest

from nsof_tpu.pipelines import runner as jrunner
from nsof_tpu_torch.pipelines import runner as trunner
from nsof_tpu_torch.utils.reporting import SEG_COLUMNS
from torch_runner_scene import assert_csv_values_equal, assert_timing_keys, read_csv, scenes
from torch_single_thread import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("runner_seg")
    jscene, tscene = scenes()
    ref = jrunner.run_segmentation(jscene, out / "jax.csv", out / "jax.txt")
    got = trunner.run_segmentation(tscene, out / "torch.csv", out / "torch.txt", device="cpu")
    return out, got, ref


def test_masks(runs):
    _, got, ref = runs
    for key in ("masks", "masks_full"):
        g, r = getattr(got, key), np.asarray(getattr(ref, key))
        assert g.shape == r.shape == (4, 96, 128) and g.dtype == r.dtype
        assert (g == r).mean() >= 0.995, (key, (g == r).mean())
    assert got.masks.any(), "the ROI path found no motion"


def test_metrics(runs):
    _, got, ref = runs
    assert set(got.metrics) == set(ref.metrics) == {"mem_pa_mean", "orig_pa_mean"}
    for k in ref.metrics:
        assert abs(got.metrics[k] - ref.metrics[k]) <= 1e-4, k
    assert_timing_keys(got.timing, ref.timing)


def test_csv_and_log(runs):
    out, *_ = runs
    head, rows = read_csv(out / "torch.csv")
    assert head == SEG_COLUMNS and len(rows) == 4
    assert_csv_values_equal(out / "torch.csv", out / "jax.csv")
    got = (out / "torch.txt").read_text().splitlines()
    ref = (out / "jax.txt").read_text().splitlines()
    assert len(got) == len(ref) == 5
    assert [g.split(":")[0] for g in got[1:]] == [r.split(":")[0] for r in ref[1:]]
