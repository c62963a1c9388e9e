"""The port's utilities against the JAX package's.

- ``utils/reporting.py``: the three CSV schemas equal the JAX lists, and
  the CSV and text files written from the same rows are byte-equal.
- ``utils/flow_viz.py``: ``flow_to_image`` against the JAX function (run op
  by op, as the server and the CLI call it) on N(0, 3²) flows made with
  numpy from a seed, with and without clipping and BGR order: ≥ 99.9 % of
  pixels equal, the rest within one level (torch's atan2 and XLA's may be
  one float32 ulp apart, ROADMAP queue 3).  Measured on the CPU: 100 %
  equal.  The color wheel is equal.
- ``utils/timing.py``: ``time_fn`` and ``StageTimer`` report the JAX
  package's keys; ``profile_trace`` writes a Chrome trace.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsof_tpu.utils import flow_viz as jviz
from nsof_tpu.utils import reporting as jrep
from nsof_tpu.utils import timing as jtiming
from nsof_tpu_torch.utils import flow_viz as tviz
from nsof_tpu_torch.utils import reporting as trep
from nsof_tpu_torch.utils import timing as ttiming


@pytest.mark.parametrize("name", ["SEG_COLUMNS", "OB_COLUMNS", "PRED_COLUMNS"])
def test_schemas_equal(name):
    assert getattr(trep, name) == getattr(jrep, name)


def test_csv_and_log_bytes_equal(tmp_path):
    rows = [{"Frame_Pair": "2.jpg-1.jpg", "Mem_PA": "97.1234", "Region_Percent": "12.50"},
            {"Frame_Pair": "3.jpg-2.jpg", "Cal_Times": "0.0012", "unknown": "dropped"}]
    for pkg, sub in ((trep, "torch"), (jrep, "jax")):
        report = pkg.CsvReport(tmp_path / sub / "m.csv", pkg.SEG_COLUMNS)
        log = pkg.TextLog(tmp_path / sub / "m.txt")
        for row in rows:
            report.add(row)
            log.write(json.dumps(row))
    for name in ("m.csv", "m.txt"):
        assert (tmp_path / "torch" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_colorwheel_equal():
    np.testing.assert_array_equal(tviz.make_colorwheel(), jviz.make_colorwheel())


@pytest.mark.parametrize("kwargs", [{}, {"clip_flow": 2.0}, {"convert_to_bgr": True}])
def test_flow_to_image_against_jax(kwargs):
    rng = np.random.default_rng(7)
    equal = total = 0
    for shape in ((96, 128), (61, 83)):
        flow = rng.normal(0.0, 3.0, shape + (2,)).astype(np.float32)
        ref = np.asarray(jviz.flow_to_image(jnp.asarray(flow), **kwargs)).astype(np.int64)
        got = tviz.flow_to_image(torch.from_numpy(flow), **kwargs).numpy()
        assert got.dtype == np.uint8 and got.shape == shape + (3,)
        diff = np.abs(got.astype(np.int64) - ref).max(axis=-1)
        assert diff.max() <= 1, diff.max()
        equal += int((diff == 0).sum())
        total += diff.size
    assert equal / total >= 0.999, equal / total


def test_flow_to_image_zero_flow():
    flow = np.zeros((8, 9, 2), np.float32)
    np.testing.assert_array_equal(tviz.flow_to_image(torch.from_numpy(flow)).numpy(),
                                  np.asarray(jviz.flow_to_image(jnp.asarray(flow))))


def test_timing_reports_the_jax_keys(tmp_path):
    calls = []
    got = ttiming.time_fn(lambda x: calls.append(x) or torch.ones(3) * x, 2.0, warmup=1, iters=3)
    ref = jtiming.time_fn(lambda x: jnp.ones(3) * x, 2.0, warmup=1, iters=3)
    assert set(got) == set(ref) and got["iters"] == 3 and len(calls) == 4
    assert 0 <= got["min_s"] <= got["p50_s"] <= got["max_s"]
    timer = ttiming.StageTimer()
    for _ in range(2):
        with timer.time("stage"):
            torch.zeros(4).sum()
    assert list(timer.summary()) == ["stage"] and len(timer.records["stage"]) == 2
    with ttiming.profile_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert len(prof.key_averages()) > 0
