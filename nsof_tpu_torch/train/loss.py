"""Training losses and metrics for the deep flow backends: the port of
:mod:`nsof_tpu.train.loss`.

``sequence_loss`` is RAFT's (codebase/RAFT/train.py:47-72);
``flowformer_sequence_loss`` is FlowFormer's variant
(codebase/FlowFormer-Official/core/loss.py:5-42), which normalises by the
full pixel count rather than the valid count and adds EPE-quality metrics
bucketed by ground-truth flow magnitude (loss.py:33-40).

Tensor operations only: every loss and metric is a 0-dim tensor on the
flows' device, so a train step reads nothing back to the host.

Data parallelism: with ``psum`` (a function that sums a tensor over the
ranks that hold the other rows of the batch, without gradient), each count
and sum that a mean divides by is the global batch's, and so is every
metric.  The loss a rank returns is then its rows' share of the global
batch's loss: the ranks' losses and their gradients sum to the global
ones.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

MAX_FLOW = 400.0

# FlowFormer's GT-magnitude buckets (core/loss.py:12)
FLOW_GT_THRESHOLDS: tuple[int, ...] = (5, 10, 20)


def _valid_and_epe(flow_preds, flow_gt, valid, max_flow):
    mag = torch.sqrt((flow_gt ** 2).sum(dim=-1))
    valid = (valid >= 0.5) & (mag < max_flow)
    epe_map = torch.sqrt(((flow_preds[-1] - flow_gt) ** 2).sum(dim=-1))
    return mag, valid, epe_map


def _no_psum(x: torch.Tensor) -> torch.Tensor:
    return x


def _epe_metrics(epe_map, valid, denom, psum) -> dict[str, torch.Tensor]:
    zero = torch.zeros((), dtype=epe_map.dtype, device=epe_map.device)
    out = {"epe": psum(torch.where(valid, epe_map, zero).sum()) / denom}
    for t in (1, 3, 5):
        out[f"{t}px"] = psum((valid & (epe_map < t)).sum()) / denom
    return out


def sequence_loss(
    flow_preds: Sequence[torch.Tensor],
    flow_gt: torch.Tensor,
    valid: torch.Tensor,
    gamma: float = 0.8,
    max_flow: float = MAX_FLOW,
    psum: Callable[[torch.Tensor], torch.Tensor] = _no_psum,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """γ-weighted L1 over refinement iterations with valid/max-flow masking.

    Args:
        flow_preds: per-iteration ``[B, H, W, 2]`` predictions.
        flow_gt: ``[B, H, W, 2]`` ground truth.
        valid: ``[B, H, W]`` validity (bool or {0, 1}).

    Returns (loss, metrics dict with epe / 1px / 3px / 5px).
    """
    n = len(flow_preds)
    _, valid, epe_map = _valid_and_epe(flow_preds, flow_gt, valid, max_flow)
    denom = psum(valid.sum()).clamp_min(1)
    zero = torch.zeros((), dtype=flow_gt.dtype, device=flow_gt.device)

    loss = 0.0
    for i, pred in enumerate(flow_preds):
        w = gamma ** (n - i - 1)
        i_loss = (pred - flow_gt).abs().sum(dim=-1)
        loss = loss + w * torch.where(valid, i_loss, zero).sum() / denom
    return loss, _epe_metrics(epe_map, valid, denom, psum)


def flowformer_sequence_loss(
    flow_preds: Sequence[torch.Tensor],
    flow_gt: torch.Tensor,
    valid: torch.Tensor,
    gamma: float = 0.8,
    max_flow: float = MAX_FLOW,
    gt_thresholds: Sequence[int] = FLOW_GT_THRESHOLDS,
    psum: Callable[[torch.Tensor], torch.Tensor] = _no_psum,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """FlowFormer's sequence loss (core/loss.py:5-42).

    Differences vs :func:`sequence_loss`, kept deliberately:
    - each iteration's term is ``(valid * |err|).mean()`` over ALL pixels
      (loss.py:21) — the invalid fraction scales the loss down, unlike
      RAFT's valid-count normalisation;
    - extra metrics ``{t}-th-5px`` = P(EPE<5px | valid ∧ |gt|<t) for
      t ∈ (5, 10, 20) px (loss.py:33-40) — accuracy on slow/medium/fast
      pixels.  Empty buckets yield NaN, matching torch's empty-mean.
    """
    n = len(flow_preds)
    mag, valid, epe_map = _valid_and_epe(flow_preds, flow_gt, valid, max_flow)
    vmask = valid[..., None].to(flow_gt.dtype)
    numel = psum(torch.full((), flow_gt.numel(), dtype=torch.int64, device=flow_gt.device))

    loss = 0.0
    for i, pred in enumerate(flow_preds):
        w = gamma ** (n - i - 1)
        loss = loss + w * (vmask * (pred - flow_gt).abs()).sum() / numel

    metrics = _epe_metrics(epe_map, valid, psum(valid.sum()).clamp_min(1), psum)
    fast = (epe_map < 5).to(torch.float32)
    nan = torch.full((), float("nan"), device=flow_gt.device)
    for t in gt_thresholds:
        bucket = valid & (mag < t)
        cnt = psum(bucket.sum())
        mean = psum(torch.where(bucket, fast, 0.0).sum()) / cnt.clamp_min(1)
        metrics[f"{t}-th-5px"] = torch.where(cnt > 0, mean, nan)
    return loss, metrics
