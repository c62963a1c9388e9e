"""PyTorch + CUDA port of :mod:`nsof_tpu`'s ROI-gated segmentation path.

A package of its own beside the JAX one: it imports ``torch`` and numpy,
never ``jax`` and nothing of ``nsof_tpu``.  Its kernels are CUDA C++ for
Hopper (``csrc/``), built with ``nvcc`` on first use by :mod:`._build`;
every ``kernel_mode`` of the JAX package's fast Farnebäck has its route.

Entry point: :func:`nsof_tpu_torch.pipelines.segmentation.seg_batch_fast`.
"""

from nsof_tpu_torch.config import DATASETS, PipelineConfig, config_from_dict

__all__ = ["DATASETS", "PipelineConfig", "config_from_dict"]
