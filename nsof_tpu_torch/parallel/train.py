"""RAFT and FlowFormer training steps on one device: the port of
:mod:`nsof_tpu.parallel.train`.

The JAX module jits each step over a device mesh (dp over 'data', tp over
'model'); here a step runs on one device, given as ``device`` in place of
the mesh (default the CUDA device; without one it raises unless
``device='cpu'``).  Mapping dp/tp onto ``torch.distributed`` is the parallel
slice's work.

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
from torch import nn

from nsof_tpu_torch import _build
from nsof_tpu_torch.models.raft import RAFT, RaftConfig
from nsof_tpu_torch.train.loss import flowformer_sequence_loss, sequence_loss
from nsof_tpu_torch.train.optim import ClippedAdamW, flowformer_optimizer, raft_optimizer


@dataclasses.dataclass
class TrainState:
    """What a train step advances: the model's parameters, the optimizer's
    moments and schedule, and the count of steps taken."""

    model: nn.Module
    tx: ClippedAdamW
    step: int = 0

    @property
    def params(self) -> dict[str, torch.Tensor]:
        return self.model.state_dict()


def _seeded_init(make, seed: int) -> nn.Module:
    """``make()`` with torch's CPU generator seeded with ``seed``, leaving
    the global generator as it was (the JAX functions' PRNG key)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return make()


def create_train_state(
    rng: int = 0,
    device=None,
    cfg: RaftConfig = RaftConfig(),
    lr: float = 4e-4,
    num_steps: int = 100_000,
):
    """A RAFT initialised from the seed ``rng`` on ``device`` with its
    optimizer (:func:`~nsof_tpu_torch.train.optim.raft_optimizer`).  Returns
    ``(model, tx, state)``."""
    dev = _build.resolve_device(device)
    model = _seeded_init(lambda: RAFT(cfg), rng).to(dev)
    tx = raft_optimizer(model, lr=lr, num_steps=num_steps)
    return model, tx, TrainState(model, tx, 0)


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


def _step_fn(model: nn.Module, tx: ClippedAdamW, device, forward, loss_fn):
    dev = _build.resolve_device(device)

    def train_step(state: TrainState, batch: dict):
        b = to_device(batch, dev)
        model.train()
        preds = forward(b["image1"], b["image2"])
        loss, metrics = loss_fn(preds, b["flow"], b["valid"])
        tx.zero_grad()
        loss.backward()
        tx.step()
        state.step += 1
        return state, {k: v.detach() for k, v in dict(metrics, loss=loss).items()}

    return train_step


def make_train_step(model: RAFT, tx: ClippedAdamW, device=None, iters: int = 12,
                    gamma: float = 0.8):
    """``train_step(state, batch) -> (state, metrics)``.

    batch: dict with image1/image2 ``[B, H, W, 3]``, flow ``[B, H, W, 2]``,
    valid ``[B, H, W]`` (numpy arrays or tensors)."""
    return _step_fn(model, tx, device,
                    lambda a, b: model(a, b, iters=iters),
                    lambda p, f, v: sequence_loss(p, f, v, gamma))


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
    """A freshly initialised FlowFormer on ``device`` with its optimizer;
    the defaults are things_eval's trainer block (the JAX config's).
    ``twins_lr_factor`` trains the twins backbones at a reduced lr
    (optimizer/__init__.py:22-33).  Returns ``(model, tx, state)``."""
    from nsof_tpu_torch.models.flowformer import FlowFormer, FlowFormerConfig

    dev = _build.resolve_device(device)
    cfg = cfg or FlowFormerConfig()
    model = _seeded_init(lambda: FlowFormer(cfg), rng).to(dev)
    tx = flowformer_optimizer(model, lr=lr, num_steps=num_steps, wdecay=wdecay, eps=eps,
                              clip=clip, twins_lr_factor=twins_lr_factor)
    return model, tx, TrainState(model, tx, 0)


def make_flowformer_step(model, tx: ClippedAdamW, device=None, gamma: float = 0.8):
    """FlowFormer's ``train_step(state, batch)``, as :func:`make_train_step`."""
    return _step_fn(model, tx, device, model,
                    lambda p, f, v: flowformer_sequence_loss(p, f, v, gamma))
