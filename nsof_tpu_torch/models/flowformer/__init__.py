"""FlowFormer (latent cost tokens) in PyTorch: the port of
:mod:`nsof_tpu.models.flowformer`."""

from nsof_tpu_torch.models.flowformer.config import (  # noqa: F401
    FF_EXPERIMENTS,
    FlowFormerConfig,
    get_experiment,
)
from nsof_tpu_torch.models.flowformer.model import (  # noqa: F401
    FlowFormer,
    compute_grid_indices,
    compute_weight,
    tiled_flow,
)
