"""PyTorch + CUDA port of :mod:`nsof_tpu`: the ROI-gated segmentation path,
the exact Farnebäck with the reference's dual path, and the tracking and
prediction heads.

A package of its own beside the JAX one: it imports ``torch`` and numpy,
never ``jax`` and nothing of ``nsof_tpu``.  Its kernels are CUDA C++ for
Hopper (``csrc/``), built with ``nvcc`` on first use by :mod:`._build`;
every ``kernel_mode`` of the JAX package's fast Farnebäck has its route.

Entry points: ``seg_batch_fast`` and the exact path's ``seg_batch``,
``seg_step`` and ``seg_stages`` in :mod:`.pipelines.segmentation`;
``tracking_batch_fast`` and the rest of :mod:`.pipelines.tracking`;
``prediction_batch_fast`` and the rest of :mod:`.pipelines.prediction`.
"""

from nsof_tpu_torch.config import DATASETS, PipelineConfig, config_from_dict

__all__ = ["DATASETS", "PipelineConfig", "config_from_dict"]
