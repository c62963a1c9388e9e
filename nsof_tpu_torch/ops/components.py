"""Connected components and component statistics, batched over B.

Counterpart of :mod:`nsof_tpu.ops.components` (``label_components``,
``component_stats``, ``connected_components_with_stats``) for a batch of
small masks ``[B, H, W]`` — the device-state grids that gate the ROI
(6×8 on the headline workload).

Labels are *min linear index* roots, as in the JAX package: every pixel of
a component carries the smallest row-major index of that component.  The
JAX version propagates minima in a while-loop run to its fixpoint.  Here
the fixpoint is reached in a number of steps fixed by the grid size, with
no host round trip: the grid's adjacency matrix, self-loops included, is
squared ``ceil(log2(H·W))`` times, which gives reachability over every
path of up to ``H·W − 1`` steps, and a pixel's label is the least index it
reaches.  The work is O(B·(HW)³·log HW), meant for device-state grids
(at most a few hundred cells), not for image-sized masks.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

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


def component_stats(labels: torch.Tensor, k_max: int = 16) -> dict:
    """Per-component bounding boxes and areas in ``k_max`` static slots
    (ascending root id; components beyond ``k_max`` are dropped).

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
