"""Batched binary morphology on ``[B, H, W]`` boolean masks.

Counterpart of :mod:`nsof_tpu.ops.morphology_fast`.  The decomposition is
the same and exact: dilation by an SE whose rows are solid runs is the OR,
over the SE rows, of a horizontal window OR of the row's run shifted
vertically; each window OR is built by shift doubling; erosion is the
complement of the dilation of the complement.  The JAX package packs 32
columns per uint32 word for the TPU's lanes.  Here the masks stay unpacked
booleans with W contiguous, which has no word-tail invariant to keep and
gives the same bits (held by ``tests/test_torch_morphology.py``).
"""

from __future__ import annotations

import numpy as np
import torch


def se_row_runs(se: np.ndarray) -> list[tuple[int, int, int]]:
    """(dy, left_extent, right_extent) for each nonempty SE row; offsets
    relative to the anchor (ksize//2).  Each row must be one solid run
    (holds for cv2 elliptical SEs)."""
    kh, kw = se.shape
    ay, ax = kh // 2, kw // 2
    runs = []
    for i in range(kh):
        cols = np.nonzero(se[i])[0]
        if cols.size == 0:
            continue
        if not (np.diff(cols) == 1).all():
            raise ValueError("SE row is not a solid run")
        runs.append((i - ay, int(cols[0] - ax), int(cols[-1] - ax)))
    return runs


def _shift(x: torch.Tensor, d: int, dim: int) -> torch.Tensor:
    """out[i] = x[i + d] along ``dim``, False outside."""
    if d == 0:
        return x
    n = x.shape[dim]
    out = torch.zeros_like(x)
    if abs(d) >= n:
        return out
    if d > 0:
        out.narrow(dim, 0, n - d).copy_(x.narrow(dim, d, n - d))
    else:
        out.narrow(dim, -d, n + d).copy_(x.narrow(dim, 0, n + d))
    return out


def _window_or_w(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """out[..., i] = OR of x[..., i+left .. i+right], False outside."""
    k = right - left + 1
    if k == 1:
        return _shift(x, left, -1)
    w = x.shape[-1]
    lp = max(0, -left)
    f = torch.nn.functional.pad(x, (lp, max(0, right)))
    span = 1
    while span * 2 <= k:
        f = f | _shift(f, span, -1)
        span *= 2
    if span < k:
        f = f | _shift(f, k - span, -1)
    start = lp + left
    return f[..., start : start + w]


def _or_over_se(x: torch.Tensor, se: np.ndarray) -> torch.Tensor:
    """out(p) = OR over SE offsets k of x(p + k − anchor)."""
    out = None
    by_run: dict[tuple[int, int], list[int]] = {}
    for dy, left, right in se_row_runs(se):
        by_run.setdefault((left, right), []).append(dy)
    for (left, right), dys in by_run.items():
        row = _window_or_w(x, left, right)
        for dy in dys:
            shifted = _shift(row, dy, -2)
            out = shifted if out is None else (out | shifted)
    return out


def dilate_erode_n_masked(
    mask: torch.Tensor, inbox: torch.Tensor, se: np.ndarray, iterations: int
) -> torch.Tensor:
    """N × (dilate ∘ erode) with the seg head's crop-border re-masking on
    ``[B, H, W]`` masks: x = dilate(x ∧ ib); x = erode(x ∨ ¬ib) per
    iteration, then x ∧ ib.  Counterpart of the JAX package's
    ``dilate_erode_n_masked_hwb`` (which takes ``[H, W, B]``)."""
    x = mask.bool()
    ib = inbox.bool()
    for _ in range(iterations):
        x = _or_over_se(x & ib, se)
        # erode(y) = ¬ dilate(¬y);  ¬(x ∨ ¬ib) = ¬x ∧ ib
        x = ~_or_over_se(~x & ib, se)
    return x & ib
