"""Connected components, component statistics and NMS, batched over B.

Counterpart of :mod:`nsof_tpu.ops.components` for batches of masks
``[B, H, W]``.  Labels are *min linear index* roots, as in the JAX package:
every pixel of a component carries the smallest row-major index of that
component.  Such labels are unique to the components, so any correct
labelling gives the same labels, and two forms serve two scales:

- :func:`label_components`, for the device-state grids that gate the ROI
  (6×8 on the headline workload): the grid's adjacency matrix, self-loops
  included, is squared ``ceil(log2(H·W))`` times, which gives reachability
  over every path of up to ``H·W − 1`` steps, and a pixel's label is the
  least index it reaches.  No host round trip; O(B·(HW)³·log HW) work, for
  grids of at most a few hundred cells.
- :func:`label_components_sweep`, for image-sized masks (the tracking
  head's windows): the JAX package's sweep, a neighbour minimum and then
  segmented running minima along rows and columns, repeated until a sweep
  changes nothing or 256 sweeps.  The JAX ``while_loop`` tests after every
  sweep on the device; here the host reads one flag every 8 sweeps (at most
  32 synchronisations a call).  Sweeps past the fixpoint change nothing,
  so the labels are the JAX labels.

:func:`component_stats` reduces the grid form's labels to per-component
boxes and areas over one-hot masks; :func:`component_stats_scatter` gives
the same for image-sized labels with ``scatter_reduce``, where one-hot
masks would not fit.  On the 6×8 grid at B = 256 the one-hot form is the
faster (``python -m nsof_tpu_torch.time_gate``).

:func:`nms` is greedy NMS as N steps over the batch (the tracking head's);
:func:`nms_batch` computes the same keep masks in one launch of kernel K9
on the card (the YOLO post step's).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from nsof_tpu_torch import _build

_BIG = 2**30  # sentinel label for background / empty slots


@functools.lru_cache(maxsize=64)
def _neighbour_pairs(h: int, w: int, connectivity: int, device: str):
    """Linear indices ``(src, dst)`` of every in-grid neighbour pair of an
    ``h × w`` grid, built once on the host and kept on ``device``, so that
    labelling indexes with integers and never syncs on a boolean mask."""
    shifts = [(-1, 0), (1, 0), (0, -1), (0, 1)]
    if connectivity == 8:
        shifts += [(-1, -1), (-1, 1), (1, -1), (1, 1)]
    y, x = np.indices((h, w)).reshape(2, -1)
    src, dst = [], []
    for dy, dx in shifts:
        ok = (y + dy >= 0) & (y + dy < h) & (x + dx >= 0) & (x + dx < w)
        src.append((y * w + x)[ok])
        dst.append(((y + dy) * w + x + dx)[ok])
    pairs = torch.from_numpy(np.stack([np.concatenate(src), np.concatenate(dst)]))
    return pairs.to(device)


def label_components(mask: torch.Tensor, connectivity: int = 4) -> torch.Tensor:
    """Label the components of ``[B, H, W]`` masks (nonzero = active).

    Returns int32 labels: background -1, each component labelled by the
    minimum linear index of its pixels.
    """
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    act = mask > 0
    b, h, w = act.shape
    n = h * w
    flat = act.reshape(b, n)
    # adjacency: pixel p reaches neighbour q when both are active
    idx = torch.arange(n, device=act.device)
    adj = torch.zeros(b, n, n, dtype=torch.float32, device=act.device)
    adj[:, idx, idx] = flat.float()
    src, dst = _neighbour_pairs(h, w, connectivity, str(act.device))
    adj[:, src, dst] = (flat[:, src] & flat[:, dst]).float()
    # 0/1 products with sums ≤ n are exact in float32 (and in TF32)
    for _ in range(max(1, math.ceil(math.log2(max(n, 2))))):
        adj = (torch.bmm(adj, adj) > 0).float()
    lin = torch.arange(n, dtype=torch.int32, device=act.device)
    reach = torch.where(adj > 0, lin, torch.full_like(lin, _BIG))
    labels = reach.amin(dim=2)
    labels = torch.where(flat, labels, torch.full_like(labels, -1))
    return labels.reshape(b, h, w)


_SEG_BITS = 31  # a label (≤ _BIG) fits below this bit of a scan key
MAX_SWEEPS = 256  # the JAX package's max_sweeps
CHECK_EVERY = 8  # sweeps between two host reads of the convergence flag


def _neighbour_min(lab: torch.Tensor, connectivity: int) -> torch.Tensor:
    """Min of each label and its in-image neighbours' labels."""
    h, w = lab.shape[-2:]
    lp = torch.nn.functional.pad(lab, (1, 1, 1, 1), value=_BIG)
    shifts = [(-1, 0), (1, 0), (0, -1), (0, 1)]
    if connectivity == 8:
        shifts += [(-1, -1), (-1, 1), (1, -1), (1, 1)]
    out = lab
    for dy, dx in shifts:
        out = torch.minimum(out, lp[..., 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w])
    return out


def _segmented_cummin(lab: torch.Tensor, resets: torch.Tensor, dim: int,
                      reverse: bool) -> torch.Tensor:
    """Running minimum of ``lab`` along ``dim``, restarted at every reset
    (a reset element starts its segment).  The key puts the segment's rank
    counted from the far end above the label, so a plain ``cummin`` never
    carries a minimum across a reset."""
    if reverse:
        lab, resets = lab.flip(dim), resets.flip(dim)
    seg = torch.cumsum(resets, dim)
    key = ((lab.shape[dim] - seg) << _SEG_BITS) | lab
    out = torch.cummin(key, dim).values & ((1 << _SEG_BITS) - 1)
    return out.flip(dim) if reverse else out


def label_components_sweep(mask: torch.Tensor, connectivity: int = 4) -> torch.Tensor:
    """Label the components of image-sized ``[B, H, W]`` masks (nonzero =
    active) by the JAX package's sweep; int32 labels, background -1, each
    component labelled by the minimum linear index of its pixels.

    Synchronises with the host once every ``CHECK_EVERY`` sweeps, and stops
    when those sweeps changed nothing or after ``MAX_SWEEPS``.
    """
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    act = mask > 0
    h, w = act.shape[-2:]
    resets = (~act).long()
    lin = torch.arange(h * w, device=act.device).reshape(h, w)
    big = torch.full((), _BIG, dtype=torch.long, device=act.device)
    lab = torch.where(act, lin, big)
    for _ in range(MAX_SWEEPS // CHECK_EVERY):
        before = lab
        for _ in range(CHECK_EVERY):
            lab = torch.where(act, _neighbour_min(lab, connectivity), big)
            for dim in (-1, -2):
                for reverse in (False, True):
                    lab = _segmented_cummin(lab, resets, dim, reverse)
            lab = torch.where(act, lab, big)
        if not bool((lab != before).any()):
            break
    return torch.where(act, lab, -1).to(torch.int32)


def component_stats(labels: torch.Tensor, k_max: int = 16) -> dict:
    """Per-component bounding boxes and areas in ``k_max`` static slots
    (ascending root id; components beyond ``k_max`` are dropped), for the
    grid form's labels: each slot reduced over a ``[B, HW, k_max]`` one-hot
    mask.

    Returns ``boxes`` [B, k_max, 4] int32 (x, y, w, h), ``areas``
    [B, k_max] int32, ``valid`` [B, k_max] bool, ``count`` [B] int32.
    """
    b, h, w = labels.shape
    dev = labels.device
    flat = labels.reshape(b, h * w).long()
    lin = torch.arange(h * w, device=dev)
    is_root = flat == lin
    rank = torch.cumsum(is_root.long(), dim=1) - 1  # slot of each root
    # slot of each pixel's component; background and overflow → k_max
    slot = torch.gather(rank, 1, flat.clamp(min=0))
    slot = torch.where((flat >= 0) & (slot < k_max), slot, torch.full_like(slot, k_max))
    onehot = slot[:, :, None] == torch.arange(k_max, device=dev)  # [B, HW, k]
    ys = (lin // w)[None, :, None]
    xs = (lin % w)[None, :, None]
    big = torch.full((), _BIG, dtype=torch.long, device=dev)
    x0 = torch.where(onehot, xs, big).amin(dim=1)
    y0 = torch.where(onehot, ys, big).amin(dim=1)
    x1 = torch.where(onehot, xs, -big).amax(dim=1)
    y1 = torch.where(onehot, ys, -big).amax(dim=1)
    areas = onehot.sum(dim=1)
    return _stats(x0, y0, x1, y1, areas)


def component_stats_scatter(labels: torch.Tensor, k_max: int = 16) -> dict:
    """:func:`component_stats` for image-sized labels, where the one-hot
    masks would take gigabytes (four int64 ``[64, 98304, 16]`` tensors for a
    B = 64 batch of 256×384 windows): the same slots reduced with
    ``scatter_reduce`` into ``k_max + 1`` slots, the last one taking the
    background and the overflow."""
    b, h, w = labels.shape
    dev = labels.device
    flat = labels.reshape(b, h * w).long()
    lin = torch.arange(h * w, device=dev)
    rank = torch.cumsum((flat == lin).long(), dim=1) - 1  # slot of each root
    slot = torch.gather(rank, 1, flat.clamp(min=0))
    slot = torch.where((flat >= 0) & (slot < k_max), slot, k_max)
    ys = (lin // w).expand(b, -1)
    xs = (lin % w).expand(b, -1)

    def reduce(vals, fill, how):
        out = torch.full((b, k_max + 1), fill, dtype=torch.long, device=dev)
        return out.scatter_reduce(1, slot, vals, how)[:, :k_max]

    x0, y0 = reduce(xs, _BIG, "amin"), reduce(ys, _BIG, "amin")
    x1, y1 = reduce(xs, -_BIG, "amax"), reduce(ys, -_BIG, "amax")
    return _stats(x0, y0, x1, y1, reduce(torch.ones_like(xs), 0, "sum"))


def _stats(x0, y0, x1, y1, areas) -> dict:
    valid = areas > 0
    boxes = torch.stack([x0, y0, x1 - x0 + 1, y1 - y0 + 1], dim=-1)
    boxes = torch.where(valid[..., None], boxes, torch.zeros_like(boxes))
    return {
        "boxes": boxes.to(torch.int32),
        "areas": areas.to(torch.int32),
        "valid": valid,
        "count": valid.sum(dim=1).to(torch.int32),
    }


def connected_components_with_stats(
    mask: torch.Tensor, connectivity: int = 4, k_max: int = 16
) -> dict:
    """Label + stats in one call (cv2.connectedComponentsWithStats parity,
    minus label-image ordering), batched over B."""
    labels = label_components(mask, connectivity)
    out = component_stats(labels, k_max)
    out["labels"] = labels
    return out


def nms(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
        iou_thresh: float, plus_one: bool = True) -> torch.Tensor:
    """Greedy non-maximum suppression of ``[B, N, 4]`` (x1, y1, x2, y2)
    float boxes scored by ``[B, N]``, candidates ``valid`` ``[B, N]``:
    py_cpu_nms (optical_flow_ob.py:96-135) with its inclusive (+1) widths,
    or exclusive ones with ``plus_one=False``.  Returns the ``[B, N]`` keep
    mask.

    N steps, each over the whole batch, with no host synchronisation; the
    highest score alive is kept (the first of equal scores, as
    ``jnp.argmax`` picks it) and suppresses every box with IoU > thresh.
    """
    boxes = boxes.float()
    scores = scores.float()
    n = boxes.shape[1]
    one = 1.0 if plus_one else 0.0
    x1, y1, x2, y2 = boxes.unbind(-1)
    areas = (y2 - y1 + one) * (x2 - x1 + one)
    ids = torch.arange(n, device=boxes.device)
    alive = valid.bool()
    keep = torch.zeros_like(alive)
    for _ in range(n):
        i = torch.where(alive, scores, -torch.inf).argmax(dim=1, keepdim=True)
        any_alive = alive.any(dim=1, keepdim=True)
        picked = ids == i
        keep = keep | (picked & any_alive)

        def at(v):
            return v.gather(1, i)

        ww = (torch.minimum(at(x2), x2) - torch.maximum(at(x1), x1) + one).clamp(min=0.0)
        hh = (torch.minimum(at(y2), y2) - torch.maximum(at(y1), y1) + one).clamp(min=0.0)
        inter = ww * hh
        iou = inter / (at(areas) + areas - inter)
        suppress = (iou > iou_thresh) | picked
        alive = torch.where(any_alive, alive & ~suppress, alive)
    return keep


def _nms_cuda(boxes, scores, valid, iou_thresh, plus_one):
    b, n = scores.shape
    if boxes.shape != (b, n, 4) or valid.shape != (b, n):
        raise ValueError(f"nms_batch: boxes {tuple(boxes.shape)}, scores {(b, n)} and valid "
                         f"{tuple(valid.shape)} do not match")
    if not (boxes.device == scores.device == valid.device):
        raise ValueError("nms_batch: boxes, scores and valid on different devices")
    boxes = boxes.float().contiguous()
    if boxes.data_ptr() % 16:  # the kernel reads a box as one float4
        boxes = boxes.clone()
    scores = scores.float().contiguous()
    valid = valid.bool().contiguous()
    keep = torch.empty((b, n), dtype=torch.bool, device=boxes.device)
    if b == 0 or n == 0:
        return keep
    alive = torch.empty((b, n), dtype=torch.uint8, device=boxes.device)  # the kernel's flags
    fn = _build.launcher("nms", 5, 3, n_float=1)
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    _build.check(fn(boxes.data_ptr(), scores.data_ptr(), valid.data_ptr(), keep.data_ptr(),
                    alive.data_ptr(), b, n, int(plus_one), iou_thresh, stream), "nms")
    _build.LAUNCHES["nms"] += 1
    return keep


def nms_batch(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
              iou_thresh: float, plus_one: bool = True) -> torch.Tensor:
    """:func:`nms` in one launch: kernel K9 (``csrc/nms.cu``, one block a
    batch row) on a CUDA tensor, equal to :func:`nms` bit for bit; the plain
    :func:`nms` on a CPU tensor.  ``[B, N, 4]`` boxes, ``[B, N]`` scores and
    candidates → the ``[B, N]`` keep mask."""
    if boxes.is_cuda:
        return _nms_cuda(boxes, scores, valid, iou_thresh, plus_one)
    return nms(boxes, scores, valid, iou_thresh, plus_one)


def box_iou(box_a: torch.Tensor, box_b: torch.Tensor) -> torch.Tensor:
    """IoU of (x1, y1, x2, y2) boxes ``[..., 4]`` with exclusive
    coordinates (the tracking accuracy metric, optical_flow_ob.py:589-609)."""
    xa = torch.maximum(box_a[..., 0], box_b[..., 0])
    ya = torch.maximum(box_a[..., 1], box_b[..., 1])
    xb = torch.minimum(box_a[..., 2], box_b[..., 2])
    yb = torch.minimum(box_a[..., 3], box_b[..., 3])
    inter = (xb - xa).clamp(min=0.0) * (yb - ya).clamp(min=0.0)
    area_a = (box_a[..., 2] - box_a[..., 0]) * (box_a[..., 3] - box_a[..., 1])
    area_b = (box_b[..., 2] - box_b[..., 0]) * (box_b[..., 3] - box_b[..., 1])
    return inter / (area_a + area_b - inter).clamp(min=1e-9)
