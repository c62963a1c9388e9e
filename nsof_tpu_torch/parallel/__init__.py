"""Parallelism on ``torch.distributed``, the port of :mod:`nsof_tpu.parallel`:
the ('data', 'model') device mesh (:mod:`.mesh`), data-parallel segmentation
(:mod:`.inference`), row-sharded Farnebäck (:mod:`.spatial`), pipelined RAFT
(:mod:`.pipeline`) and the RAFT and FlowFormer train steps on one device or
over dp × tp (:mod:`.train`)."""

from nsof_tpu_torch.parallel.mesh import (  # noqa: F401
    data_sharding,
    make_mesh,
    replicated,
    shard_params_conv_tp,
)
from nsof_tpu_torch.parallel.inference import make_sharded_seg_batch  # noqa: F401
from nsof_tpu_torch.parallel.pipeline import (  # noqa: F401
    make_raft_pp_flow,
    pipeline_stages,
    tied_stage_params,
)
