"""PyTorch + CUDA port of :mod:`nsof_tpu`'s ROI-gated segmentation path.

A package of its own beside the JAX one: it imports ``torch`` and numpy,
never ``jax`` and nothing of ``nsof_tpu``.  Its kernels are CUDA C++ for
Hopper (``csrc/``), built with ``nvcc`` on first use by :mod:`._build`.

Entry point: :func:`nsof_tpu_torch.pipelines.segmentation.seg_batch_fast`.
"""

from nsof_tpu_torch.config import DATASETS, PipelineConfig, config_from_dict

__all__ = ["DATASETS", "PipelineConfig", "config_from_dict"]
