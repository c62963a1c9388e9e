"""Object detection on neuromorphic ROIs: the port of
:mod:`nsof_tpu.pipelines.detection` (the reference's
``optical_flow_yolo.py``).

The reference runs ultralytics YOLOv8 on each ROI crop and on the full
frame, maps region detections back to full-image coordinates, and compares
detection counts, classes and times (run_yolo_on_regions :442-588,
run_yolo_on_full_image :590-682).  :func:`run_detection` gates each frame
pair on the device (``ops/roi.py::roi_boxes``), crops the merged box on the
host and calls a :class:`Detector` on the crop and on the frame:

- :class:`TorchYoloDetector`: the port's YOLOv8 (:mod:`..models.yolov8`) on
  the card, the JAX detector's letterbox on the host without OpenCV
  (``data/imgproc.py::resize_linear`` is ``cv2.resize(INTER_LINEAR)``), the
  class-aware NMS on kernel K9;
- :class:`ThresholdBlobDetector`: the deterministic weightless stand-in,
  OpenCV's gray conversion, threshold and 8-connected stats in numpy and
  scipy;
- :class:`UltralyticsDetector`: ultralytics itself, when installed.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Protocol

import numpy as np
import scipy.ndimage
import torch

from nsof_tpu_torch import _build
from nsof_tpu_torch.data.gt_tooling import components_cv2_order
from nsof_tpu_torch.data.imgproc import resize_linear
from nsof_tpu_torch.data.scenes import SceneData
from nsof_tpu_torch.models import yolov8 as y8
from nsof_tpu_torch.ops import roi as roi_ops
from nsof_tpu_torch.ops.colorspace import bgr_to_gray_u8
from nsof_tpu_torch.utils import reporting

YOLO_CONFIDENCE = 0.25  # optical_flow_yolo.py:83-85
YOLO_IOU_THRESHOLD = 0.45
YOLO_COLUMNS = [
    "YOLO_Region_Time",
    "YOLO_Full_Time",
    "YOLO_Time_Improvement",
    "YOLO_Time_Improvement_Percent",
    "YOLO_Region_Detections_Count",
    "YOLO_Full_Detections_Count",
    "YOLO_Region_Classes",
    "YOLO_Region_Confidences",
    "YOLO_Full_Classes",
    "YOLO_Full_Confidences",
]


@dataclasses.dataclass
class Detection:
    bbox: tuple[float, float, float, float]  # x1, y1, x2, y2 full-image
    confidence: float
    class_id: int
    class_name: str


class Detector(Protocol):
    def __call__(self, image_bgr: np.ndarray) -> list[Detection]: ...


class UltralyticsDetector:
    """YOLOv8 via ultralytics, when installed (optional-import guarded the
    same way the reference guards it, optical_flow_yolo.py:34-39)."""

    def __init__(self, weights: str = "yolov8n.pt", conf: float = YOLO_CONFIDENCE,
                 iou: float = YOLO_IOU_THRESHOLD):
        try:
            from ultralytics import YOLO
        except ImportError as e:
            raise ImportError(
                "ultralytics is not installed; pass a custom Detector or "
                "install the 'detect' extra"
            ) from e
        self.model = YOLO(weights)
        self.conf = conf
        self.iou = iou

    def __call__(self, image_bgr: np.ndarray) -> list[Detection]:
        results = self.model(image_bgr, conf=self.conf, iou=self.iou, verbose=False)
        out = []
        for result in results:
            if result.boxes is None:
                continue
            boxes = result.boxes.xyxy.cpu().numpy()
            confs = result.boxes.conf.cpu().numpy()
            classes = result.boxes.cls.cpu().numpy()
            for box, conf, cls in zip(boxes, confs, classes):
                out.append(Detection(tuple(box), float(conf), int(cls),
                                     self.model.names[int(cls)]))
        return out


COCO_NAMES = (
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep",
    "cow", "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
    "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "couch", "potted plant", "bed", "dining table", "toilet", "tv",
    "laptop", "mouse", "remote", "keyboard", "cell phone", "microwave",
    "oven", "toaster", "sink", "refrigerator", "book", "clock", "vase",
    "scissors", "teddy bear", "hair drier", "toothbrush",
)


class TorchYoloDetector:
    """The port's YOLOv8 behind the :class:`Detector` protocol
    (``JaxYoloDetector``'s counterpart).

    Per call, batch 1: ultralytics-style letterbox to a static ``imgsz``
    square (gray 114 padding) on the host, one upload, the forward, the
    decode and :func:`~..models.yolov8.postprocess` (K9) on ``device``, one
    download, boxes mapped back to source coordinates.  Takes a converted
    ``state_dict`` (:func:`~..models.yolov8.convert_yolov8`, or
    :func:`~..models.yolov8.params_from_jax`); build from an ultralytics
    checkpoint with :func:`for_checkpoint`.  Runs on ``device`` (default the
    CUDA device; raises ``RuntimeError`` without one unless
    ``device='cpu'``)."""

    def __init__(self, state_dict, config=None, imgsz: int = 640,
                 conf: float = YOLO_CONFIDENCE, iou: float = YOLO_IOU_THRESHOLD,
                 class_names: tuple[str, ...] = COCO_NAMES, device=None):
        self.device = _build.resolve_device(device)
        self.config = config or y8.YoloConfig()
        self.model = y8.YOLOv8(self.config)
        self.model.load_state_dict(state_dict)
        self.model.to(self.device).eval()
        self.imgsz = imgsz
        self.conf = conf
        self.iou = iou
        self.class_names = class_names

    @classmethod
    def for_checkpoint(cls, path: str, **kw):
        model, state = y8.pretrained_yolov8(path)
        return cls(state, model.config, **kw)

    def letterbox(self, image_bgr: np.ndarray):
        """(canvas ``[imgsz, imgsz, 3]`` uint8 BGR, gain, top, left): the
        image scaled to fit, centred on a 114-gray square."""
        h0, w0 = image_bgr.shape[:2]
        gain = min(self.imgsz / h0, self.imgsz / w0)
        nh, nw = round(h0 * gain), round(w0 * gain)
        resized = resize_linear(np.ascontiguousarray(image_bgr), nw, nh)
        canvas = np.full((self.imgsz, self.imgsz, 3), 114, dtype=np.uint8)
        top = (self.imgsz - nh) // 2
        left = (self.imgsz - nw) // 2
        canvas[top : top + nh, left : left + nw] = resized
        return canvas, gain, top, left

    def upload(self, canvas: np.ndarray) -> torch.Tensor:
        """A letterboxed BGR canvas → ``[1, 3, imgsz, imgsz]`` RGB in [0, 1]
        on the device."""
        img = canvas[..., ::-1].astype(np.float32) / 255.0  # BGR→RGB
        return torch.from_numpy(np.ascontiguousarray(img.transpose(2, 0, 1)))[None].to(
            self.device)

    def run(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        """The forward, the decode and the post step (K9 on the card) of one
        uploaded batch; the fixed-shape outputs of its first sample."""
        with torch.no_grad():
            boxes, scores = y8.decode_predictions(self.model(x), self.config.num_classes)
            post = y8.postprocess(boxes, scores, self.conf, self.iou)
        return {k: v[0] for k, v in post.items()}

    @staticmethod
    def download(post: dict[str, torch.Tensor]) -> np.ndarray:
        """The post step's outputs in one host read: ``[K, 7]`` float32
        rows of (x1, y1, x2, y2, score, class, valid)."""
        return torch.cat([post["boxes"], post["scores"][:, None],
                          post["classes"][:, None].float(), post["valid"][:, None].float()],
                         dim=1).cpu().numpy()

    def detections(self, host: np.ndarray, shape, gain: float, top: int,
                   left: int) -> list[Detection]:
        """The valid rows of :meth:`download`'s array mapped back to the
        source image of ``shape`` (h, w), in the JAX detector's float32
        numpy arithmetic."""
        h0, w0 = shape[:2]
        valid = host[:, 6] > 0
        out = []
        for b, s, c in zip(host[valid, :4], host[valid, 4], host[valid, 5].astype(np.int32)):
            x1 = float(np.clip((b[0] - left) / gain, 0, w0))
            y1 = float(np.clip((b[1] - top) / gain, 0, h0))
            x2 = float(np.clip((b[2] - left) / gain, 0, w0))
            y2 = float(np.clip((b[3] - top) / gain, 0, h0))
            name = (self.class_names[int(c)]
                    if int(c) < len(self.class_names) else str(int(c)))
            out.append(Detection((x1, y1, x2, y2), float(s), int(c), name))
        return out

    def __call__(self, image_bgr: np.ndarray) -> list[Detection]:
        canvas, gain, top, left = self.letterbox(image_bgr)
        host = self.download(self.run(self.upload(canvas)))
        return self.detections(host, image_bgr.shape, gain, top, left)


class ThresholdBlobDetector:
    """Deterministic detector for tests / weightless environments: bright
    blobs above a threshold become class-0 detections.  OpenCV's
    ``COLOR_BGR2GRAY``, ``THRESH_BINARY`` and 8-connected stats, in its
    label order, on the host."""

    def __init__(self, thresh: int = 200, min_area: int = 50):
        self.thresh = thresh
        self.min_area = min_area

    def __call__(self, image_bgr: np.ndarray) -> list[Detection]:
        gray = bgr_to_gray_u8(torch.from_numpy(np.ascontiguousarray(image_bgr))).numpy()
        labels, order, areas = components_cv2_order(gray > self.thresh)
        spans = scipy.ndimage.find_objects(labels)
        out = []
        for i in order:
            if areas[i] >= self.min_area:
                ys, xs = spans[i - 1]
                out.append(Detection((xs.start, ys.start, xs.stop, ys.stop), 1.0, 0, "blob"))
        return out


@dataclasses.dataclass
class DetectionFrameResult:
    frame: str
    region_detections: list[Detection]
    full_detections: list[Detection]
    region_time_s: float
    full_time_s: float
    region_box: Optional[tuple[int, int, int, int]]


def run_detection(scene: SceneData, detector: Detector, csv_path: Optional[str] = None,
                  device=None) -> list[DetectionFrameResult]:
    """Detect on ROI crops vs full frames across a scene.

    The ROI comes from the device-state map exactly as in the flow
    pipelines (the merged FLAG=2 box of ``roi_boxes``, on ``device``: the
    CUDA device by default, raising ``RuntimeError`` without one unless
    ``device='cpu'``), read by the host once a pair; crops are host-side
    numpy slices because detectors are host-side.  Region detections are
    mapped back to full-image coordinates (optical_flow_yolo.py:516-523).
    The CSV has the segmentation columns (the pair's name filled) and the
    reference's 10 YOLO columns."""
    dev = _build.resolve_device(device)
    cfg = scene.cfg
    results = []
    report = None
    if csv_path:
        report = reporting.CsvReport(csv_path, reporting.SEG_COLUMNS + YOLO_COLUMNS)

    for i in range(scene.num_pairs):
        mem2 = torch.from_numpy(np.ascontiguousarray(scene.mem_gray[i + 1][None])).to(dev)
        frame = scene.frames_bgr[i + 1]
        r = roi_ops.roi_boxes(mem2, cfg.image_h, cfg.image_w, cfg.roi)
        *merged, active = torch.cat([r["merged"][0], r["any_active"].to(torch.int32)]).tolist()
        region_dets: list[Detection] = []
        region_time = 0.0
        region_box = None
        if active:
            x0, y0, x1, y1 = merged
            region_box = (x0, y0, x1, y1)
            crop = frame[y0:y1, x0:x1]
            if crop.size:
                t0 = time.perf_counter()
                dets = detector(crop)
                region_time = time.perf_counter() - t0
                for d in dets:
                    bx = d.bbox
                    region_dets.append(dataclasses.replace(
                        d, bbox=(bx[0] + x0, bx[1] + y0, bx[2] + x0, bx[3] + y0)))
        t0 = time.perf_counter()
        full_dets = detector(frame)
        full_time = time.perf_counter() - t0

        results.append(DetectionFrameResult(
            frame=scene.names[i + 1],
            region_detections=region_dets,
            full_detections=full_dets,
            region_time_s=region_time,
            full_time_s=full_time,
            region_box=region_box,
        ))
        if report:
            imp = full_time - region_time
            report.add({
                "Frame_Pair": f"{scene.names[i+1]}-{scene.names[i]}",
                "YOLO_Region_Time": f"{region_time:.4f}",
                "YOLO_Full_Time": f"{full_time:.4f}",
                "YOLO_Time_Improvement": f"{imp:.4f}",
                "YOLO_Time_Improvement_Percent": f"{100 * imp / max(full_time, 1e-9):.2f}",
                "YOLO_Region_Detections_Count": len(region_dets),
                "YOLO_Full_Detections_Count": len(full_dets),
                "YOLO_Region_Classes": ";".join(d.class_name for d in region_dets),
                "YOLO_Region_Confidences": ";".join(f"{d.confidence:.2f}" for d in region_dets),
                "YOLO_Full_Classes": ";".join(d.class_name for d in full_dets),
                "YOLO_Full_Confidences": ";".join(f"{d.confidence:.2f}" for d in full_dets),
            })
    return results
