"""Optimizers: AdamW + one-cycle + global-norm clipping, the port of
:mod:`nsof_tpu.train.optim`.

``raft_optimizer`` mirrors fetch_optimizer (codebase/RAFT/train.py:79-86):
AdamW(lr, wd, eps) with a one-cycle schedule (pct_start=0.05, linear
anneal) and grad-clip 1.0 (:177).  ``flowformer_optimizer`` mirrors
build_optimizer/build_scheduler (codebase/FlowFormer-Official/core/
optimizer/__init__.py:15-61): the same, optionally with the twins backbone
parameter group trained at ``lr × twins_lr_factor`` (:22-33) on its own
scaled schedule (:54-57).

Each piece computes what the JAX package's optax chain computes:

- :func:`onecycle_schedule` is ``optax.linear_onecycle_schedule(num_steps +
  100, lr, pct_start=0.05, pct_final=1.0)`` evaluated as optax evaluates it,
  in float32 from float64 knots: it rises from lr/25 at step 0 to lr at
  ``int(0.05·(num_steps + 100))``, falls linearly to lr·1e-4 at
  ``num_steps + 100`` and stays there (optax's dictionary of knots lets the
  last one replace the pct_final knot).  It is not torch's ``OneCycleLR``,
  which ends at lr/25/1e4, peaks one step earlier and raises past its last
  step.  A ``LambdaLR`` drives it, so the first update uses ``schedule(0)``.
- :func:`clip_grad_global_norm_` is ``optax.clip_by_global_norm``: the
  gradients are scaled by ``max_norm / ‖g‖`` only when ``‖g‖ ≥ max_norm``
  (``clip_grad_norm_`` would divide by ``‖g‖ + 1e-6`` every time), as tensor
  operations, so the step reads nothing back to the host.
- on a mesh (:meth:`ClippedAdamW.distribute`) the gradients are first summed
  over the ranks of 'data' (one all-reduce), and the global norm counts
  each tensor-parallel shard once (the shards' squares all-reduced over
  'model') and each replicated parameter once, as JAX's
  ``clip_by_global_norm`` over the global arrays does;
- ``torch.optim.AdamW`` is ``optax.adamw``: Adam's step plus ``wd·p`` on
  every parameter (biases and norms included, no mask), times −lr; ``eps``
  outside the square root, betas (0.9, 0.999).
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

BETAS = (0.9, 0.999)

# the twins backbones, selected by substring over parameter names as the
# reference does (optimizer/__init__.py:26-30): the port's feature backbone
# lives at memory_encoder.feat_encoder.*, the context one at context_encoder.*
TWINS_BACKBONE_MODULES = ("feat_encoder", "context_encoder")


def onecycle_schedule(lr: float, num_steps: int) -> Callable[[int], float]:
    """The JAX package's ``_onecycle(lr, num_steps)`` as a function of the
    update count (0 for the first update) → learning rate."""
    total = num_steps + 100
    bounds = np.array([0, int(0.05 * total), total])
    values = np.cumprod([lr / 25.0, 25.0, 1e-4])
    starts, ends = bounds[:-1], bounds[1:]
    delta = (values[1:] - values[:-1]).astype(np.float32)
    first = values[:-1].astype(np.float32)
    last = np.float32(values[-1])

    def schedule(count: int) -> float:
        inside = (starts <= count) & (count < ends)
        pct = (count - starts).astype(np.float32) / (ends - starts).astype(np.float32)
        interp = delta * pct + first
        return float(np.float32(np.where(inside, interp, np.float32(0)).sum())
                     + np.float32(total <= count) * last)

    return schedule


def _sq_norm(grads: list[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    if not grads:
        return torch.zeros((), dtype=like.dtype, device=like.device)
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads))) ** 2


def clip_grad_global_norm_(params: Iterable[torch.Tensor], max_norm: float,
                           sharded: Iterable[torch.Tensor] = (), group=None) -> torch.Tensor:
    """Scale the gradients of ``params`` in place by ``max_norm / ‖g‖`` when
    their global norm ``‖g‖ ≥ max_norm`` (``optax.clip_by_global_norm``).
    The parameters in ``sharded`` each hold one shard of a tensor split
    over ``group``: their squares are all-reduced over it.  Returns the
    norm, a 0-dim tensor; nothing is read back to the host."""
    params = [p for p in params if p.grad is not None]
    grads = [p.grad for p in params]
    if group is None:
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    else:
        ids = {id(p) for p in sharded}
        sq_shards = _sq_norm([p.grad for p in params if id(p) in ids], grads[0])
        dist.all_reduce(sq_shards, group=group)
        norm = torch.sqrt(_sq_norm([p.grad for p in params if id(p) not in ids], grads[0])
                          + sq_shards)
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


class ClippedAdamW:
    """``optax.chain(clip_by_global_norm(clip), adamw(schedule, wd, eps))``
    over a module's parameters, in one or more groups, each with its own
    schedule: :meth:`step` clips, updates and advances the schedules."""

    def __init__(self, groups: list[tuple[list[nn.Parameter], Callable[[int], float]]],
                 wdecay: float, eps: float, clip: float):
        self.clip = clip
        self.params = [p for ps, _ in groups for p in ps]
        # each group's base lr is 1, so its lr is its schedule's value exactly
        self.optimizer = torch.optim.AdamW([{"params": ps, "lr": 1.0} for ps, _ in groups],
                                           lr=1.0, betas=BETAS, eps=eps, weight_decay=wdecay)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(self.optimizer,
                                                           [s for _, s in groups])
        # on a mesh (distribute): the 'data' and 'model' process groups and
        # the parameters that hold one 'model' shard each
        self.data_group = self.model_group = None
        self.sharded: list[nn.Parameter] = []

    def distribute(self, data_group, model_group, sharded: Iterable[nn.Parameter]) -> None:
        """Sum the gradients over ``data_group`` before each update and count
        ``sharded``'s shards once each (over ``model_group``) in the clip's
        global norm."""
        self.data_group, self.model_group = data_group, model_group
        self.sharded = list(sharded)

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self) -> torch.Tensor:
        """Clip, update, advance; returns the gradients' global norm.  A
        parameter the loss does not reach gets a zero gradient, so it still
        decays, as in optax (AdamW skips a parameter without one)."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.data_group is not None:
            grads = [p.grad for p in self.params]
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=self.data_group)
            torch._foreach_copy_(grads, [f.view_as(g) for f, g in
                                         zip(flat.split([g.numel() for g in grads]), grads)])
        norm = clip_grad_global_norm_(self.params, self.clip, self.sharded, self.model_group)
        self.optimizer.step()
        self.scheduler.step()
        return norm

    def lrs(self) -> list[float]:
        """Each group's learning rate for the next update."""
        return [g["lr"] for g in self.optimizer.param_groups]

    def state_dict(self) -> dict:
        return {"optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])


def raft_optimizer(
    model: nn.Module,
    lr: float = 4e-4,
    num_steps: int = 100_000,
    wdecay: float = 1e-4,
    eps: float = 1e-8,
    clip: float = 1.0,
) -> ClippedAdamW:
    return ClippedAdamW([(list(model.parameters()), onecycle_schedule(lr, num_steps))],
                        wdecay, eps, clip)


def is_twins_backbone(name: str) -> bool:
    return any(m in name for m in TWINS_BACKBONE_MODULES)


def flowformer_optimizer(
    model: nn.Module,
    lr: float = 12.5e-5,
    num_steps: int = 120_000,
    wdecay: float = 1e-4,
    eps: float = 1e-8,
    clip: float = 1.0,
    twins_lr_factor: Optional[float] = None,
) -> ClippedAdamW:
    """FlowFormer optimizer; with ``twins_lr_factor`` set, the backbone
    encoders' parameters get their own schedule peaking at ``lr·factor``
    while everything else peaks at ``lr`` (two parameter groups, main
    first, optimizer/__init__.py:26-33 + :54-57)."""
    if twins_lr_factor is None:
        return raft_optimizer(model, lr, num_steps, wdecay, eps, clip)
    named = list(model.named_parameters())
    main = [p for n, p in named if not is_twins_backbone(n)]
    backbone = [p for n, p in named if is_twins_backbone(n)]
    return ClippedAdamW([(main, onecycle_schedule(lr, num_steps)),
                         (backbone, onecycle_schedule(lr * twins_lr_factor, num_steps))],
                        wdecay, eps, clip)
