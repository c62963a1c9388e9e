"""Device meshes on ``torch.distributed``: the port of
:mod:`nsof_tpu.parallel.mesh`.

The JAX package lays its devices out as a ``jax.sharding.Mesh`` over
('data', 'model') and lets XLA GSPMD insert the collectives.  Here a mesh is
a :class:`torch.distributed.device_mesh.DeviceMesh` with the same dimension
names, one process (rank) a device, and every collective is an explicit
``torch.distributed`` call on one of its dimensions' process groups.

:func:`init_mesh` starts the default process group when none exists: from
``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT`` when a launcher
such as ``torchrun`` set them, else at world size 1 on a free local port.
The backend is NCCL on the CUDA device; gloo only when the caller passes
``device='cpu'``.  Without a CUDA device and without ``device='cpu'`` it
raises, as every entry point of the port does: a rank never falls back to
the CPU.
"""

from __future__ import annotations

import datetime
import os
import socket

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from nsof_tpu_torch import _build

# every process group the port starts waits this long for its peers
TIMEOUT = datetime.timedelta(seconds=300)


def free_port() -> int:
    """A TCP port on the loopback interface that was free when asked."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _init_process_group(device_type: str) -> None:
    backend = "gloo" if device_type == "cpu" else "nccl"
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise ValueError(f"the default process group runs {dist.get_backend()}, "
                             f"a {device_type} mesh needs {backend}")
        return
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://", timeout=TIMEOUT,
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    else:
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{free_port()}",
                                rank=0, world_size=1, timeout=TIMEOUT)


def init_mesh(shape: tuple[int, ...], names: tuple[str, ...], device=None,
              ranks=None) -> DeviceMesh:
    """A mesh of ``shape`` with dimensions ``names`` over ``ranks`` (default
    the first ``prod(shape)`` ranks), row-major, starting the default
    process group first if needed (see the module docstring)."""
    device_type = _build.resolve_device(device).type
    _init_process_group(device_type)
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size()
    ranks = list(range(n)) if ranks is None else list(ranks)
    if len(ranks) != n:
        raise ValueError(f"init_mesh: {len(ranks)} ranks for a mesh of {shape}")
    if max(ranks) >= world:
        raise ValueError(f"init_mesh: ranks {ranks} outside a process group of {world}; "
                         f"start {n} processes (torchrun --nproc-per-node {n})")
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(shape), mesh_dim_names=names)


def make_mesh(n_devices: int | None = None, model_parallel: int = 1, devices=None,
              device=None) -> DeviceMesh:
    """('data', 'model') mesh over the process group's ranks (``devices``: a
    list of ranks, default all of them; ``n_devices`` takes the first ones).
    Raises ``ValueError`` when the group has fewer than ``n_devices`` ranks
    or ``model_parallel`` does not divide the count."""
    device_type = _build.resolve_device(device).type
    _init_process_group(device_type)
    ranks = list(devices) if devices is not None else list(range(dist.get_world_size()))
    if n_devices is not None:
        if len(ranks) < n_devices:
            raise ValueError(
                f"make_mesh: requested {n_devices} devices but the process group "
                f"exposes only {len(ranks)}. Either pass fewer devices, or start "
                f"{n_devices} ranks (torchrun --nproc-per-node {n_devices}; gloo ranks "
                "with device='cpu')."
            )
        ranks = ranks[:n_devices]
    n = len(ranks)
    if n % model_parallel != 0:
        raise ValueError(f"make_mesh: {n} devices not divisible by "
                         f"model_parallel={model_parallel}")
    return init_mesh((n // model_parallel, model_parallel), ("data", "model"),
                     device=device_type, ranks=ranks)


def mesh_shape(mesh: DeviceMesh) -> dict[str, int]:
    """``{dimension name: size}``, as ``jax.sharding.Mesh.shape``."""
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def data_sharding(mesh: DeviceMesh) -> tuple:
    """Batch-dim sharding for inputs: ``Shard(0)`` over 'data', replicated
    over 'model' (one placement per mesh dimension)."""
    return tuple(Shard(0) if name == "data" else Replicate() for name in mesh.mesh_dim_names)


def replicated(mesh: DeviceMesh) -> tuple:
    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def local_rows(x, mesh: DeviceMesh, axis: str = "data"):
    """This rank's rows of the global batch ``x`` (a tensor or numpy array,
    rows on dim 0) under ``Shard(0)`` over ``axis``; raises ``ValueError``
    when the axis' size does not divide the batch, as ``shard_map`` does."""
    n, i = mesh.size(mesh.mesh_dim_names.index(axis)), mesh.get_local_rank(axis)
    b = x.shape[0]
    if b % n:
        raise ValueError(f"batch of {b} does not divide over the {n} ranks of '{axis}'")
    return x[i * (b // n):(i + 1) * (b // n)]


def shard_params_conv_tp(model: nn.Module, mesh: DeviceMesh | None = None,
                         min_features: int = 128) -> dict[str, int | None]:
    """Tensor-parallel layout: for each parameter name (every name a shared
    parameter is registered under), the dim sharded over 'model', or
    ``None`` where it is replicated.

    The JAX rule (``mesh.py:65-70``, Flax's ``[kh, kw, cin, cout]`` kernels)
    in torch's layout: a 4-D convolution weight ``[cout, cin, kh, kw]`` with
    ``cout ≥ min_features`` is sharded on dim 0 (its output channels), and so
    is a 1-D parameter of ``≥ min_features`` (such a convolution's bias, or a
    normalisation's scale and shift).  ``mesh`` is unused, as the layout
    depends on the shapes alone; it is there for the JAX signature."""
    del mesh

    def spec(p: torch.Tensor):
        if p.ndim == 4 and p.shape[0] >= min_features:
            return 0
        if p.ndim == 1 and p.shape[0] >= min_features:
            return 0
        return None

    return {name: spec(p) for name, p in model.named_parameters(remove_duplicate=False)}


def is_first_rank(mesh: DeviceMesh | None) -> bool:
    """Whether this process is the mesh's first rank (the one that writes
    files); ``True`` without a mesh."""
    return mesh is None or dist.get_rank() == int(mesh.mesh.flatten()[0])


def mesh_barrier(mesh: DeviceMesh) -> None:
    """Return on every rank of ``mesh`` only once each of them has called it:
    an all-reduce over each dimension in turn, read on the host."""
    token = torch.zeros(1, device=mesh_device(mesh))
    for name in mesh.mesh_dim_names:
        dist.all_reduce(token, group=mesh.get_group(name))
    token.cpu()
