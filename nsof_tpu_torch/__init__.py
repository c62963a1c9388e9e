"""PyTorch + CUDA port of :mod:`nsof_tpu`: the ROI-gated segmentation path,
the exact Farnebäck with the reference's dual path, the tracking and
prediction heads, the device simulation with the streaming pipelines, the
FLAG=1 separate regions, the Canny gate, the serving engine, the demo
server, the scene runners, the deep backends with their training, YOLOv8
detection on the ROI, the result visualiser, and the CLI.

A package of its own beside the JAX one: it imports ``torch`` and numpy,
never ``jax`` and nothing of ``nsof_tpu``.  Its kernels are CUDA C++ for
Hopper (``csrc/``), built with ``nvcc`` on first use by :mod:`._build`;
every ``kernel_mode`` of the JAX package's fast Farnebäck has its route.

Entry points: ``seg_batch_fast`` and the exact path's ``seg_batch``,
``seg_step`` and ``seg_stages`` in :mod:`.pipelines.segmentation`;
``tracking_batch_fast`` and the rest of :mod:`.pipelines.tracking`;
``prediction_batch_fast`` and the rest of :mod:`.pipelines.prediction`;
``stream_masks``, ``stream_masks_chunked`` and ``stream_masks_from_events``
in :mod:`.pipelines.stream` (frames → device scan, kernel K8 → ROI flow);
``seg_step_separate``, ``tracking_step_separate``,
``prediction_step_separate`` and ``separate_flow_field`` in
:mod:`.pipelines.separate`; the device layer, :mod:`.device`
(``compress_frames``, ``simulate_frames``, ``bin_events`` with the native
binner of :mod:`.native`, ``simulate_events``, ``simulate_events_stream``);
``canny_edges`` and ``canny_roi_boxes`` in :mod:`.ops.canny`;
``BatchingEngine`` in :mod:`.serve.engine` and the demo server in
:mod:`.serve.app`; ``run_segmentation``, ``run_tracking`` and
``run_prediction`` over a :class:`~.data.scenes.SceneData` in
:mod:`.pipelines.runner`; RAFT and FlowFormer in :mod:`.models`, their
deep pipelines in :mod:`.pipelines.deep_flow`; training: the train steps
in :mod:`.parallel.train`, ``run_stage`` and ``run_curriculum`` in
:mod:`.train.curriculum`, checkpoints in :mod:`.train.trainer`, evaluation
in :mod:`.train.evaluate`, the training data in :mod:`.data.flow_datasets`;
YOLOv8 at every scale in :mod:`.models.yolov8` (its post step's NMS on
kernel K9), ``TorchYoloDetector``, ``ThresholdBlobDetector`` and
``run_detection`` in :mod:`.pipelines.detection`; ``visualize_npz`` and
``write_video`` in :mod:`.utils.visualize`; the command line,
``python -m nsof_tpu_torch`` (or ``.cli``).  Its image
I/O is PNG (and PPM for training frames), by its own codecs
(:mod:`.utils.png`, :mod:`.utils.ppm`).
"""

from nsof_tpu_torch.config import DATASETS, PipelineConfig, config_from_dict

__all__ = ["DATASETS", "PipelineConfig", "config_from_dict"]
