"""Data-parallel batched inference: the port of
:mod:`nsof_tpu.parallel.inference`.

The JAX package runs ``seg_batch_fast`` under ``shard_map`` over the mesh's
'data' axis: each device runs its own kernel instances on its rows of the
batch, with no collective in the steady state.  Here each rank takes its
rows of the global batch (:func:`~nsof_tpu_torch.parallel.mesh.local_rows`),
runs the port's ``seg_batch_fast`` on its own device (K1–K4 on the card in
the ``'fused'`` route) and then all-gathers the outputs over 'data', so that
every rank holds the global result, as JAX's global array does.  Ranks that
differ only in 'model' compute the same rows.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from nsof_tpu_torch.config import PipelineConfig
from nsof_tpu_torch.parallel.mesh import local_rows, mesh_device
from nsof_tpu_torch.pipelines.segmentation import seg_batch_fast


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The rows of ``x`` from every rank of ``group``, concatenated in rank
    order along dim 0.  A bool tensor crosses as uint8 (gloo's all-gather
    takes no bool)."""
    flag = x.dtype == torch.bool
    x = (x.to(torch.uint8) if flag else x).contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    out = torch.cat(parts, dim=0)
    return out.bool() if flag else out


def make_sharded_seg_batch(
    mesh: DeviceMesh,
    cfg: PipelineConfig,
    warp_radius: int | None = None,
    kernel_mode: str = "auto",
):
    """Returns ``fn(mem [B, gh, gw], prev [B, H, W], next [B, H, W])`` →
    ``{"mask", "box", "any_active"}`` over the global batch, with B sharded
    over the mesh's 'data' dimension.  Every rank passes the same global
    batch (tensors or numpy arrays); B must divide by the 'data' size, else
    ``ValueError`` (pad the final partial batch at the call site)."""
    dev = mesh_device(mesh)
    group = mesh.get_group("data")

    def run(mem, prev, nxt):
        out = seg_batch_fast(local_rows(mem, mesh), local_rows(prev, mesh),
                             local_rows(nxt, mesh), cfg, warp_radius, kernel_mode, device=dev)
        return {k: all_gather_rows(out[k], group) for k in ("mask", "box", "any_active")}

    return run
