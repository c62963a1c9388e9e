"""Batched binary morphology on ``[B, H, W]`` boolean masks, and the seg
head on it.

Counterpart of :mod:`nsof_tpu.ops.morphology_fast`.  The decomposition is
the same and exact: dilation by an SE whose rows are solid runs is the OR,
over the SE rows, of a horizontal window OR of the row's run shifted
vertically; each window OR is built by shift doubling; erosion is the
complement of the dilation of the complement.  The JAX package packs 32
columns per uint32 word for the TPU's lanes.  Here the plain masks stay
unpacked booleans with W contiguous, which has no word-tail invariant to
keep and gives the same bits (held by ``tests/test_torch_morphology.py``).

The main path's seg head, :func:`seg_head` (|flow|² > th², then N ×
(dilate ∘ erode) re-masked to the box), is kernel K10 on a CUDA tensor
(``csrc/seg_head.cu``) and :func:`seg_head_plain` on a CPU tensor.  K10
replaces no TPU kernel: the JAX package's head is plain XLA
(``nsof_tpu/ops/morphology_fast.py::dilate_erode_n_masked_hwb``).  It is
bound by bytes (dx, dy, the box mask in, the uint8 mask out: 10 bytes a
pixel), where the plain version moves an unpacked boolean plane for every
shift and pad.  So it reads the flow and the box once, packs x and the box
32 columns to a word, runs each (dilate, erode) pair on tiles of packed
rows in shared memory and writes the mask once: 1 + N launches a call.
"""

from __future__ import annotations

import numpy as np
import torch

from nsof_tpu_torch import _build


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


def _se_run_groups(se: np.ndarray) -> dict[tuple[int, int], list[int]]:
    """The SE's rows by their run: (left, right) → the dys of its rows."""
    by_run: dict[tuple[int, int], list[int]] = {}
    for dy, left, right in se_row_runs(se):
        by_run.setdefault((left, right), []).append(dy)
    return by_run


def _or_over_se(x: torch.Tensor, se: np.ndarray) -> torch.Tensor:
    """out(p) = OR over SE offsets k of x(p + k − anchor)."""
    out = None
    for (left, right), dys in _se_run_groups(se).items():
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


def seg_head_plain(dx: torch.Tensor, dy: torch.Tensor, inbox: torch.Tensor,
                   th2: float, se: np.ndarray, iterations: int) -> torch.Tensor:
    """The plain version of K10: ``(dx² + dy² > th2) ∧ inbox``, then
    :func:`dilate_erode_n_masked`, as uint8 {0, 255} ``[B, H, W]``."""
    x = (dx * dx + dy * dy > th2) & inbox
    return dilate_erode_n_masked(x, inbox, se, iterations).to(torch.uint8) * 255


def seg_head(dx: torch.Tensor, dy: torch.Tensor, inbox: torch.Tensor,
             th2: float, se: np.ndarray, iterations: int) -> torch.Tensor:
    """The seg head on the flow planes ``dx``, ``dy`` ``[B, H, W]`` (any
    strides) inside ``inbox`` ``[B, H, W]`` → uint8 {0, 255} ``[B, H, W]``.

    A CUDA tensor goes through kernel K10 (it raises where the kernel
    cannot run); a CPU tensor through :func:`seg_head_plain`."""
    if dx.is_cuda:
        return _seg_head_cuda(dx, dy, inbox, th2, se, iterations)
    return seg_head_plain(dx, dy, inbox, th2, se, iterations)


# K10's limits: SE rows and columns (every tap within ±15 of the anchor),
# and columns a row (a tile of 8 packed rows fits in a block's shared memory)
SEG_HEAD_MAX_KSIZE = 31
SEG_HEAD_MAX_WIDTH = 8192


def _se_table(se: np.ndarray) -> np.ndarray:
    """K10's int32 table of ``se``: the number of distinct row runs and of
    rows, (left, right, rows) a run, then each run's rows' dys.  Raises
    ``ValueError`` for an SE beyond the kernel's limits."""
    se = np.asarray(se)
    if se.ndim != 2 or max(se.shape) > SEG_HEAD_MAX_KSIZE:
        raise ValueError(f"seg head kernel: SE shape {se.shape} beyond "
                         f"{SEG_HEAD_MAX_KSIZE}×{SEG_HEAD_MAX_KSIZE}")
    by_run = _se_run_groups(se)
    if not by_run:
        raise ValueError("seg head kernel: the SE is empty")
    head = [len(by_run), sum(len(d) for d in by_run.values())]
    for (left, right), dys in by_run.items():
        head += [left, right, len(dys)]
    return np.asarray(head + [d for dys in by_run.values() for d in dys], np.int32)


def _seg_head_cuda(dx, dy, inbox, th2, se, iterations):
    table = _se_table(se)
    if dx.dtype != torch.float32 or dy.dtype != torch.float32:
        raise ValueError(f"seg head kernel: flow must be float32, not {dx.dtype}, {dy.dtype}")
    if inbox.dtype != torch.bool:
        raise ValueError(f"seg head kernel: inbox must be bool, not {inbox.dtype}")
    if dx.ndim != 3 or dx.shape != dy.shape or dx.shape != inbox.shape:
        raise ValueError(f"seg head kernel: dx {tuple(dx.shape)}, dy {tuple(dy.shape)} and "
                         f"inbox {tuple(inbox.shape)} must be one [B, H, W]")
    if dx.stride() != dy.stride():
        raise ValueError("seg head kernel: dx and dy must have the same strides")
    b, h, w = dx.shape
    nw = (w + 31) // 32  # packed words a row
    if w > SEG_HEAD_MAX_WIDTH:
        raise ValueError(f"seg head kernel: width {w} beyond {SEG_HEAD_MAX_WIDTH}")
    if 3 * b * h * nw >= 2**31 or max(dx.stride()) >= 2**31:
        raise ValueError(f"seg head kernel: {tuple(dx.shape)} too large")
    if iterations < 0:
        raise ValueError(f"seg head kernel: iterations {iterations} < 0")
    dev = dx.device
    if not (dx.is_cuda and dy.device == dev and inbox.device == dev):
        raise ValueError("seg head kernel: dx, dy and inbox must be on one CUDA device")
    inbox = inbox.contiguous()
    scratch = torch.empty(3 * b * h * nw, dtype=torch.int32, device=dev)
    out = torch.empty((b, h, w), dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    fn = _build.launcher("seg_head", 6, 7, n_float=1)
    _build.check(fn(
        dx.data_ptr(), dy.data_ptr(), inbox.data_ptr(), table.ctypes.data,
        scratch.data_ptr(), out.data_ptr(), b, h, w, *dx.stride(), iterations, th2,
        stream,
    ), "seg_head")
    _build.LAUNCHES["seg_head"] += 1
    return out
