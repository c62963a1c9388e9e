"""Spatial (sp) parallelism: full-frame dense flow sharded over image rows
with a halo exchange, the port of :mod:`nsof_tpu.parallel.spatial`.

Each rank of the mesh's ``axis`` holds one slab of rows plus ``halo`` rows
from each neighbour (one exchange a side, ``dist.batch_isend_irecv``),
computes the exact Farnebäck flow (:func:`nsof_tpu_torch.ops.farneback.
farneback`) on the extended slab alone, keeps its own rows, and all-gathers
the rows into the full flow.  One exchange up front and one gather at the
end; no collective inside the flow.

Accuracy contract (the JAX module's): a row a rank owns is exact against the
unsharded flow when the pyramid's whole receptive field fits inside
``halo``; the first and last ranks' true image border band sees a reflected
halo (BORDER_REFLECT_101 of the slab's edge) instead of OpenCV's border
rule.  ``halo`` and the rows a rank holds should be multiples of
``2**levels`` so that the pyramids' grids align.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from nsof_tpu_torch.ops.farneback import FarnebackParams, farneback_batch
from nsof_tpu_torch.parallel.mesh import local_rows, mesh_device


def halo_exchange_rows(x: torch.Tensor, halo: int, group) -> torch.Tensor:
    """``[Hs, ...]`` local slab → ``[Hs + 2·halo, ...]`` with the neighbours'
    rows (rank order in ``group`` is row order).  Inner ranks receive their
    neighbours' edge rows through two non-wrapping exchanges; the first and
    last rank fill the missing side with ``x[1:halo+1]`` flipped (and its
    bottom mirror), bit for bit the JAX function's reflection."""
    if halo <= 0:
        return x
    if x.shape[0] <= halo:
        raise ValueError(
            f"per-shard rows ({x.shape[0]}) must exceed halo ({halo}); "
            "use fewer shards or a smaller receptive field"
        )
    n, i = dist.get_world_size(group), dist.get_rank(group)
    x = x.contiguous()
    top = x[1:halo + 1].flip(0).contiguous()
    bot = x[-halo - 1:-1].flip(0).contiguous()
    ops = []
    if i > 0:
        peer = dist.get_global_rank(group, i - 1)
        top = torch.empty_like(top)
        ops += [dist.P2POp(dist.isend, x[:halo].contiguous(), peer, group),
                dist.P2POp(dist.irecv, top, peer, group)]
    if i < n - 1:
        peer = dist.get_global_rank(group, i + 1)
        bot = torch.empty_like(bot)
        ops += [dist.P2POp(dist.isend, x[-halo:].contiguous(), peer, group),
                dist.P2POp(dist.irecv, bot, peer, group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return torch.cat([top, x, bot], dim=0)


def suggested_halo(params: FarnebackParams, max_disp: float = 8.0) -> int:
    """Receptive-field bound for one flow computation, rounded up to a
    multiple of 2**levels (pyramid grid alignment)."""
    sigma0 = (1.0 / params.pyr_scale - 1.0) * 0.5
    blur_r = max(int(sigma0 * 5) // 2, 1)
    per_level = (
        blur_r
        + params.poly_n // 2
        + params.iterations * (params.winsize // 2 + max_disp)
    )
    reach = per_level * (1.0 / params.pyr_scale) ** params.levels
    unit = 2**params.levels
    return int(-(-reach // unit)) * unit


def _gather_rows(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _slab_flow(prev: torch.Tensor, nxt: torch.Tensor, r: int, group, params, dev):
    """Flow of this rank's ``[B, Hs, W]`` slabs, rows kept: ``[B, Hs, W, 2]``."""
    rows_first = lambda a: halo_exchange_rows(a.transpose(0, 1), r, group).transpose(0, 1)  # noqa: E731
    flow = farneback_batch(rows_first(prev), rows_first(nxt), params, device=dev)
    return flow[:, r:flow.shape[1] - r] if r else flow


def make_spatial_flow(mesh: DeviceMesh, params: FarnebackParams = FarnebackParams(),
                      halo: int | None = None, axis: str = "space"):
    """Returns ``fn(prev [H, W], next [H, W])`` → flow ``[H, W, 2]`` with H
    sharded over the mesh's ``axis``.  Every rank passes the whole frames
    and gets the whole flow; H must divide by the axis size."""
    dev = mesh_device(mesh)
    group = mesh.get_group(axis)
    r = suggested_halo(params) if halo is None else halo

    def run(prev, nxt):
        slab = lambda a: local_rows(torch.as_tensor(a).to(dev), mesh, axis)[None]  # noqa: E731
        return _gather_rows(_slab_flow(slab(prev), slab(nxt), r, group, params, dev)[0],
                            group, 0)

    return run


def make_spatial_flow_batch(mesh: DeviceMesh, params: FarnebackParams = FarnebackParams(),
                            halo: int | None = None, space_axis: str = "space",
                            data_axis: str | None = "data"):
    """2-D sp × dp decomposition: ``fn(prev [B, H, W], next [B, H, W])`` →
    flow ``[B, H, W, 2]``, the batch sharded over ``data_axis`` (``None``:
    replicated) and the rows over ``space_axis``."""
    dev = mesh_device(mesh)
    space = mesh.get_group(space_axis)
    data = None if data_axis is None else mesh.get_group(data_axis)
    r = suggested_halo(params) if halo is None else halo

    def run(prev, nxt):
        def slab(a):
            a = torch.as_tensor(a).to(dev)
            if data_axis is not None:
                a = local_rows(a, mesh, data_axis)
            return local_rows(a.transpose(0, 1), mesh, space_axis).transpose(0, 1)

        flow = _gather_rows(_slab_flow(slab(prev), slab(nxt), r, space, params, dev), space, 1)
        return flow if data is None else _gather_rows(flow, data, 0)

    return run
