"""The port's detection pipeline (``nsof_tpu_torch/pipelines/detection.py``)
against the JAX package's, on the CPU, from the same seeded numpy inputs.

- ``TorchYoloDetector`` against ``JaxYoloDetector`` (YOLOv8n, synthetic
  weights, ``imgsz`` 160, conf 0.25) on crops of three aspect ratios,
  smaller and larger than ``imgsz``: the letterboxed inputs equal (the
  port's ``resize_linear`` is OpenCV's ``INTER_LINEAR``), the detections of
  equal count and classes, boxes within ``BOX_TOL`` px and scores within
  ``SCORE_TOL`` (the forwards differ by float32 rounding, ≤ 2e-4 of a raw
  output).  The synthetic weights' class scores lie within 1e-6 of each
  other (0.5848 ± 1e-6 over the anchors), so float32 rounding alone would
  decide their order and the NMS; the fixture scales the head's last class
  and box convolutions (×100 and ×10, class biases − 3) so that the image
  decides them: 25 detections of 9 classes a crop, some scores saturated
  to exactly 1.0 on both sides (ties, broken by index as both orders do).
  Measured here: boxes within 3.1e-5 px, scores equal.
- ``ThresholdBlobDetector`` against the JAX one (OpenCV) on images with
  blobs that touch only diagonally and blobs under ``min_area``: the same
  detections in the same order.
- ``run_detection`` on ``tests/torch_runner_scene.py``'s scene with both
  detectors: region boxes and detections as above, and every CSV column
  that holds no time equal.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from nsof_tpu.models import yolov8 as jy
from nsof_tpu.pipelines import detection as jdet
from nsof_tpu_torch.models import yolov8 as ty
from nsof_tpu_torch.pipelines import detection as tdet
from nsof_tpu_torch.utils import reporting
from torch_runner_scene import read_csv, scenes
from torch_single_thread import one_torch_thread  # noqa: F401  (autouse)

IMGSZ, CONF = 160, 0.25
BOX_TOL, SCORE_TOL = 1e-3, 1e-5
TIME_COLUMNS = {"YOLO_Region_Time", "YOLO_Full_Time", "YOLO_Time_Improvement",
                "YOLO_Time_Improvement_Percent"}


@pytest.fixture(scope="module")
def yolo_pair():
    """(JaxYoloDetector, TorchYoloDetector) on one synthetic YOLOv8n; the
    JAX detector records the letterboxed input of its last call."""
    cfg = jy.YoloConfig("n")
    state = jy.synthetic_state_dict(cfg, seed=1)
    for s in range(3):
        state[f"model.22.cv3.{s}.2.weight"] = state[f"model.22.cv3.{s}.2.weight"] * 100
        state[f"model.22.cv3.{s}.2.bias"] = state[f"model.22.cv3.{s}.2.bias"] - 3
        state[f"model.22.cv2.{s}.2.weight"] = state[f"model.22.cv2.{s}.2.weight"] * 10
    params = jy.convert_yolov8(state, cfg)
    jd = jdet.JaxYoloDetector(params, cfg, imgsz=IMGSZ, conf=CONF)
    run = jd._run
    seen = {}

    def recording(variables, img):
        seen["img"] = np.asarray(img)
        return run(variables, img)

    jd._run = recording
    td = tdet.TorchYoloDetector(ty.params_from_jax(params), ty.YoloConfig("n"), imgsz=IMGSZ,
                                conf=CONF, device="cpu")
    return jd, td, seen


def assert_detections_close(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert (g.class_id, g.class_name) == (r.class_id, r.class_name)
        np.testing.assert_allclose(g.bbox, r.bbox, rtol=0, atol=BOX_TOL)
        assert abs(g.confidence - r.confidence) <= SCORE_TOL


@pytest.mark.parametrize("shape", [(120, 90), (200, 320), (48, 160)],
                         ids=["tall_smaller", "wide_larger", "wide_strip"])
def test_yolo_detector_matches_jax(yolo_pair, shape):
    jd, td, seen = yolo_pair
    img = (np.random.default_rng(sum(shape)).random((*shape, 3)) * 255).astype(np.uint8)
    ref = jd(img)
    got = td(img)
    canvas, _, _, _ = td.letterbox(img)
    np.testing.assert_array_equal(canvas[..., ::-1].astype(np.float32) / 255.0, seen["img"])
    assert len(ref) > 0
    assert_detections_close(got, ref)
    for d in got:
        x1, y1, x2, y2 = d.bbox
        assert 0 <= x1 <= x2 <= shape[1] and 0 <= y1 <= y2 <= shape[0]


def _blob_image():
    """BGR blobs: two squares touching only at a corner (one 8-connected
    blob), a blob under min_area, a tall bar, blobs in raster order that
    OpenCV labels by 2×2 blocks, and one channel bright alone."""
    img = (np.random.default_rng(0).random((90, 120, 3)) * 120).astype(np.uint8)
    img[10:20, 10:20] = 255
    img[20:30, 20:30] = 250  # touches the first square diagonally
    img[5:9, 60:64] = 255  # 16 px: under min_area 50
    img[40:85, 100:104] = 230
    img[51:60, 40:50] = 255
    img[50:60, 60:70] = 255  # starts one row above the previous one
    img[70:80, 5:20, 2] = 255  # bright red alone: gray ≈ 76 + noise, below 200
    return img


@pytest.mark.parametrize("thresh,min_area", [(200, 50), (60, 5)])
def test_blob_detector_matches_jax(thresh, min_area):
    img = _blob_image()
    ref = jdet.ThresholdBlobDetector(thresh, min_area)(img)
    got = tdet.ThresholdBlobDetector(thresh, min_area)(img)
    assert len(ref) > 2
    assert [dataclasses.astuple(d) for d in got] == [
        (tuple(int(v) for v in d.bbox), d.confidence, d.class_id, d.class_name) for d in ref]


@pytest.mark.parametrize("kind", ["blob", "yolo"])
def test_run_detection_matches_jax(yolo_pair, kind, tmp_path):
    jscene, tscene = scenes()
    if kind == "blob":
        jd, td = jdet.ThresholdBlobDetector(150, 20), tdet.ThresholdBlobDetector(150, 20)
    else:
        jd, td, _ = yolo_pair
    with jax.default_device(jax.devices("cpu")[0]):
        ref = jdet.run_detection(jscene, jd, csv_path=tmp_path / "jax.csv")
    got = tdet.run_detection(tscene, td, csv_path=tmp_path / "port.csv", device="cpu")
    assert len(got) == len(ref) == tscene.num_pairs
    assert sum(r.region_box is not None for r in got) > 0
    for g, r in zip(got, ref):
        assert g.frame == r.frame and g.region_box == r.region_box
        assert_detections_close(g.region_detections, r.region_detections)
        assert_detections_close(g.full_detections, r.full_detections)
        if g.region_box:
            x0, y0, x1, y1 = g.region_box
            for d in g.region_detections:
                assert x0 <= d.bbox[0] <= d.bbox[2] <= x1 and y0 <= d.bbox[1] <= d.bbox[3] <= y1
    if kind == "blob":
        assert sum(len(g.region_detections) for g in got) > 0
    head, rows = read_csv(tmp_path / "port.csv")
    ref_head, ref_rows = read_csv(tmp_path / "jax.csv")
    assert head == ref_head == reporting.SEG_COLUMNS + tdet.YOLO_COLUMNS
    for g, r in zip(rows, ref_rows):
        assert {k: v for k, v in g.items() if k not in TIME_COLUMNS} == {
            k: v for k, v in r.items() if k not in TIME_COLUMNS}
        for k in TIME_COLUMNS:
            float(g[k])


def test_nms_batch_on_cpu_is_the_plain_loop():
    """On a CPU tensor the K9 wrapper runs the plain ``nms``."""
    from nsof_tpu_torch.ops import components as tcomp

    rng = np.random.default_rng(4)
    xy = rng.uniform(0, 50, (3, 64, 2))
    boxes = torch.from_numpy(np.concatenate([xy, xy + rng.uniform(5, 30, (3, 64, 2))],
                                            -1).astype(np.float32))
    scores = torch.from_numpy(rng.random((3, 64)).astype(np.float32))
    valid = scores > 0.2
    for plus_one in (True, False):
        got = tcomp.nms_batch(boxes, scores, valid, 0.3, plus_one)
        assert torch.equal(got, tcomp.nms(boxes, scores, valid, 0.3, plus_one))
    assert tcomp.nms_batch(boxes, scores, valid, 0.3).sum() > 3
