"""RAFT and FlowFormer training steps, on one device or over a mesh: the
port of :mod:`nsof_tpu.parallel.train`.

Each function takes ``device`` (default the CUDA device; without one it
raises unless ``device='cpu'``) or, in its place, a ('data', 'model')
:class:`~torch.distributed.device_mesh.DeviceMesh` from
:func:`~nsof_tpu_torch.parallel.mesh.make_mesh`.  On a mesh, each rank
passes the same global batch, takes its rows of it over 'data' and runs the
step on its own device; the step equals JAX's global-batch step under GSPMD:

- dp: the loss's masked mean divides by the global valid count (summed over
  'data' first, without gradient), so each rank's loss is its share of the
  global loss; the gradients are summed over 'data' (one all-reduce); the
  metrics are global sums over global counts;
- tp (RAFT): every convolution that :func:`~nsof_tpu_torch.parallel.mesh.
  shard_params_conv_tp` marks holds this rank's slice of its output
  channels (weight and bias, and so the AdamW moments) and runs column-
  parallel: its input passes an identity whose backward all-reduces over
  'model', its output an all-gather along the channels whose backward keeps
  the local slice; a marked normalisation parameter is all-gathered for
  use the same way.  The global-norm clip counts each shard once;
- FlowFormer is data-parallel only (its parameters replicated), as in JAX.

A step is the reference's train loop body (codebase/RAFT/train.py:160-180):
upload the batch (from pinned memory, without blocking, on a CUDA device),
forward in train mode (every iteration's upsampled flow), the sequence
loss, backward, global-norm clip, AdamW with the one-cycle schedule.  It
reads nothing back to the host: the metrics come back as 0-dim tensors on
the device, for the loop to read in one transfer.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.func import functional_call

from nsof_tpu_torch import _build
from nsof_tpu_torch.models.raft import RAFT, RaftConfig
from nsof_tpu_torch.parallel.mesh import local_rows, mesh_device, shard_params_conv_tp
from nsof_tpu_torch.train.loss import flowformer_sequence_loss, sequence_loss
from nsof_tpu_torch.train.optim import ClippedAdamW, flowformer_optimizer, raft_optimizer


@dataclasses.dataclass
class TrainState:
    """What a train step advances: the model's parameters, the optimizer's
    moments and schedule, and the count of steps taken; ``mesh`` is the
    ('data', 'model') mesh the state lives on (``None``: one device)."""

    model: nn.Module
    tx: ClippedAdamW
    step: int = 0
    mesh: Optional[DeviceMesh] = None

    @property
    def params(self) -> dict[str, torch.Tensor]:
        """The model's ``state_dict`` (a tp shard holds this rank's slice)."""
        return self.model.state_dict()


# ── tensor parallelism over 'model' ──────────────────────────────────────


class _CopyToModel(torch.autograd.Function):
    """Identity; the backward sums the input's gradient over 'model' (each
    rank's output channels contribute their part of it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    """All-gather along ``dim`` over 'model'; the backward keeps this rank's
    slice of the gradient (every rank holds the same full gradient)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        ctx.rank, ctx.size = dist.get_rank(group), dist.get_world_size(group)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(ctx.size)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.chunk(ctx.size, ctx.dim)[ctx.rank].contiguous(), None, None


class TensorParallel(nn.Module):
    """A leaf module whose parameters named in ``sharded`` hold this rank's
    slice of their dim 0 over ``group``, under the module's own parameter
    names (so ``state_dict`` keys do not change).  A convolution whose
    weight is sharded runs column-parallel; otherwise the sharded
    parameters are gathered for use."""

    def __init__(self, inner: nn.Module, sharded: set[str], group):
        super().__init__()
        if len(list(inner.children())):
            raise ValueError(f"tensor parallelism shards leaf modules, not {type(inner).__name__}")
        size, rank = dist.get_world_size(group), dist.get_rank(group)
        self.group = group
        self.sharded = frozenset(sharded)
        weight = inner._parameters.get("weight")
        self.column = "weight" in self.sharded and weight.ndim == 4
        for name, p in list(inner._parameters.items()):
            if p is None:
                continue
            data = p.detach()
            if name in self.sharded:
                if data.shape[0] % size:
                    raise ValueError(f"{type(inner).__name__}.{name}: {data.shape[0]} features do "
                                     f"not divide over {size} 'model' ranks")
                data = data.chunk(size, 0)[rank]
            self.register_parameter(name, nn.Parameter(data.clone()))
            # the wrapper holds the parameter now; functional_call swaps it in
            inner._parameters[name] = nn.Parameter(torch.empty(0))
        self._inner = (inner,)  # a tuple keeps it out of the module tree

    def forward(self, x):
        params = {n: p if self.column or n not in self.sharded
                  else _GatherFromModel.apply(p, 0, self.group)
                  for n, p in self._parameters.items()}
        if self.column:
            x = _CopyToModel.apply(x, self.group)
        y = functional_call(self._inner[0], params, (x,))
        return _GatherFromModel.apply(y, 1, self.group) if self.column else y


def tensor_parallel(model: nn.Module, mesh: DeviceMesh, min_features: int = 128) -> list:
    """Shard ``model`` in place over the mesh's 'model' dimension by
    :func:`shard_params_conv_tp`'s layout (every marked module becomes a
    :class:`TensorParallel`, under each name it is registered at); returns
    the sharded parameters."""
    spec = shard_params_conv_tp(model, mesh, min_features)
    group = mesh.get_group("model")
    wrap: dict[int, TensorParallel] = {}
    for prefix, module in model.named_modules():
        own = {n for n, p in module._parameters.items() if p is not None
               and spec[f"{prefix}.{n}" if prefix else n] == 0}
        if own:
            wrap[id(module)] = TensorParallel(module, own, group)
    for module in model.modules():
        for name, child in module._modules.items():
            if child is not None and id(child) in wrap:
                module._modules[name] = wrap[id(child)]
    return [p for w in wrap.values() for n, p in w.named_parameters() if n in w.sharded]


def _sharded_names(model: nn.Module) -> dict[str, "TensorParallel"]:
    """``state_dict`` key → its :class:`TensorParallel` for every sharded
    parameter of ``model``."""
    return {f"{prefix}.{n}" if prefix else n: m
            for prefix, m in model.named_modules(remove_duplicate=False)
            if isinstance(m, TensorParallel) for n in m.sharded}


def full_state_dict(state: TrainState) -> dict:
    """``{"model": ..., "tx": ...}`` with every tp shard gathered over
    'model' (parameters and AdamW moments): the one-device layout.  Every
    rank of the mesh must call it."""
    sharded, owner = _sharded_names(state.model), _param_owners(state)
    with torch.no_grad():
        gather = lambda t, m: _GatherFromModel.apply(t, 0, m.group)  # noqa: E731
        model = {k: gather(v, sharded[k]) if k in sharded else v
                 for k, v in state.model.state_dict().items()}
        tx = state.tx.state_dict()
        opt = tx["optimizer"]
        # state_dict() hands out the live slots: build new ones
        opt["state"] = {i: {k: gather(v, owner[i]) if i in owner and k != "step" else v
                            for k, v in slots.items()}
                        for i, slots in opt["state"].items()}
    return {"model": model, "tx": tx}


def load_full_state_dict(state: TrainState, saved: dict) -> None:
    """Load a one-device ``{"model", "tx"}`` into ``state``, each tp shard
    sliced out again."""
    sharded, owner = _sharded_names(state.model), _param_owners(state)
    cut = lambda t, m: t.chunk(dist.get_world_size(m.group), 0)[dist.get_rank(m.group)]  # noqa: E731
    state.model.load_state_dict({k: cut(v, sharded[k]) if k in sharded else v
                                 for k, v in saved["model"].items()})
    tx = dict(saved["tx"], optimizer=dict(saved["tx"]["optimizer"]))
    tx["optimizer"]["state"] = {i: {k: cut(v, owner[i]) if i in owner and k != "step" else v
                                    for k, v in slots.items()}
                                for i, slots in saved["tx"]["optimizer"]["state"].items()}
    state.tx.load_state_dict(tx)


def _param_owners(state: TrainState) -> dict[int, "TensorParallel"]:
    """The optimizer's index of each sharded parameter → its module."""
    owner = {}
    for m in state.model.modules():
        if isinstance(m, TensorParallel):
            for n in m.sharded:
                owner[id(m._parameters[n])] = m
    return {i: owner[id(p)] for i, p in enumerate(state.tx.params) if id(p) in owner}


def _seeded_init(make, seed: int) -> nn.Module:
    """``make()`` with torch's CPU generator seeded with ``seed``, leaving
    the global generator as it was (the JAX functions' PRNG key)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return make()


def _device(device) -> torch.device:
    if isinstance(device, DeviceMesh):
        return mesh_device(device)
    return _build.resolve_device(device)


def create_train_state(
    rng: int = 0,
    device=None,
    cfg: RaftConfig = RaftConfig(),
    lr: float = 4e-4,
    num_steps: int = 100_000,
    tp_min_features: int = 128,
):
    """A RAFT initialised from the seed ``rng`` on ``device`` (or on this
    rank's device of a mesh, every rank drawing the same weights) with its
    optimizer (:func:`~nsof_tpu_torch.train.optim.raft_optimizer`).  On a
    mesh, the convolutions with at least ``tp_min_features`` output
    channels are sharded over 'model' (lower it for small configs so the
    model dimension is exercised).  Returns ``(model, tx, state)``."""
    dev = _device(device)
    model = _seeded_init(lambda: RAFT(cfg), rng)
    mesh = device if isinstance(device, DeviceMesh) else None
    sharded = tensor_parallel(model, mesh, tp_min_features) if mesh is not None else []
    model.to(dev)
    tx = raft_optimizer(model, lr=lr, num_steps=num_steps)
    if mesh is not None:
        tx.distribute(mesh.get_group("data"), mesh.get_group("model"), sharded)
    return model, tx, TrainState(model, tx, 0, mesh)


def to_device(batch: dict, device: torch.device) -> dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors on ``device``; host memory bound
    for a CUDA device is pinned first and copied without blocking."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray) else v
        if device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t.to(device)
    return out


def _psum(group):
    """Sum a tensor over ``group``'s ranks, without gradient."""
    def psum(x: torch.Tensor) -> torch.Tensor:
        x = x.detach().clone()
        dist.all_reduce(x, group=group)
        return x

    return psum


def _step_fn(model: nn.Module, tx: ClippedAdamW, device, forward, loss_fn):
    dev = _device(device)
    mesh = device if isinstance(device, DeviceMesh) else None
    psum = _psum(mesh.get_group("data")) if mesh is not None else (lambda x: x)

    def train_step(state: TrainState, batch: dict):
        if mesh is not None:
            batch = {k: local_rows(v, mesh) for k, v in batch.items()}
        b = to_device(batch, dev)
        model.train()
        preds = forward(b["image1"], b["image2"])
        loss, metrics = loss_fn(preds, b["flow"], b["valid"], psum)
        tx.zero_grad()
        loss.backward()
        tx.step()
        state.step += 1
        return state, {k: v.detach() for k, v in dict(metrics, loss=psum(loss)).items()}

    return train_step


def make_train_step(model: RAFT, tx: ClippedAdamW, device=None, iters: int = 12,
                    gamma: float = 0.8):
    """``train_step(state, batch) -> (state, metrics)`` on ``device`` or a
    mesh (the global batch on every rank; B must divide by 'data').

    batch: dict with image1/image2 ``[B, H, W, 3]``, flow ``[B, H, W, 2]``,
    valid ``[B, H, W]`` (numpy arrays or tensors)."""
    return _step_fn(model, tx, device,
                    lambda a, b: model(a, b, iters=iters),
                    lambda p, f, v, psum: sequence_loss(p, f, v, gamma, psum=psum))


def create_flowformer_state(
    rng: int = 0,
    device=None,
    cfg=None,
    lr: float = 12.5e-5,
    num_steps: int = 120_000,
    twins_lr_factor: Optional[float] = None,
    wdecay: float = 1e-4,
    eps: float = 1e-8,
    clip: float = 1.0,
):
    """A freshly initialised FlowFormer on ``device`` (or replicated over a
    mesh's ranks: data-parallel only, as the reference trains it with
    DataParallel, train_FlowFormer.py:57) with its optimizer; the defaults
    are things_eval's trainer block (the JAX config's).
    ``twins_lr_factor`` trains the twins backbones at a reduced lr
    (optimizer/__init__.py:22-33).  Returns ``(model, tx, state)``."""
    from nsof_tpu_torch.models.flowformer import FlowFormer, FlowFormerConfig

    dev = _device(device)
    cfg = cfg or FlowFormerConfig()
    model = _seeded_init(lambda: FlowFormer(cfg), rng).to(dev)
    tx = flowformer_optimizer(model, lr=lr, num_steps=num_steps, wdecay=wdecay, eps=eps,
                              clip=clip, twins_lr_factor=twins_lr_factor)
    mesh = device if isinstance(device, DeviceMesh) else None
    if mesh is not None:
        tx.distribute(mesh.get_group("data"), mesh.get_group("model"), [])
    return model, tx, TrainState(model, tx, 0, mesh)


def make_flowformer_step(model, tx: ClippedAdamW, device=None, gamma: float = 0.8):
    """FlowFormer's ``train_step(state, batch)``, as :func:`make_train_step`."""
    return _step_fn(model, tx, device, model,
                    lambda p, f, v, psum: flowformer_sequence_loss(p, f, v, gamma, psum=psum))
