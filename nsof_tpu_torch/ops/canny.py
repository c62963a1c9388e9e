"""Canny edge detection + contour-box ROI: the ``default_ptm`` gate.

Counterpart of :mod:`nsof_tpu.ops.canny`.  The reference's earliest ROI
gate (codebase/RAFT/default_ptm.py:44-80) thresholds the memristor image at
|value−255| ≥ 1 sampled on the cell grid, runs ``cv2.Canny(transition, 128,
256)``, takes the external contours and their bounding rectangles with a
1-cell extend.

- :func:`canny_edges`: Sobel-3 gradients, L1 magnitude (cv2's default),
  4-sector non-maximum suppression, and hysteresis by 8-connected dilation
  of the strong set masked to the weak set until nothing changes.
- :func:`canny_roi_boxes`: the 8-connected components of the edges, kept
  where they touch the background connected to the border (RETR_EXTERNAL
  drops the contours nested in holes), their boxes in pixels with the
  1-cell extend and the reference's border clamp.

The JAX package runs the hysteresis and the outside flood fill as
``lax.while_loop`` s.  Here each is a loop whose step count is bounded by the
pixel count; the host reads its changed flag once every ``CHECK_EVERY``
steps, so each loop synchronises at least once (steps past the fixpoint
change nothing, so the result is the ``while_loop``'s).
"""

from __future__ import annotations

import torch

from nsof_tpu_torch import _build
from nsof_tpu_torch.ops import components as cc

CHECK_EVERY = 8  # loop steps between two host reads of the changed flag
_BIG = 2**30


def _shift(padded: torch.Tensor, dy: int, dx: int, h: int, w: int) -> torch.Tensor:
    return padded[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]


def _sobel(img: torch.Tensor):
    """Sobel-3 gradients with cv2's BORDER_REPLICATE (Canny's default)."""
    x = torch.nn.functional.pad(img.to(torch.float32)[None, None], (1, 1, 1, 1),
                                mode="replicate")[0, 0]
    gx = ((x[:-2, 2:] + 2 * x[1:-1, 2:] + x[2:, 2:])
          - (x[:-2, :-2] + 2 * x[1:-1, :-2] + x[2:, :-2]))
    gy = ((x[2:, :-2] + 2 * x[2:, 1:-1] + x[2:, 2:])
          - (x[:-2, :-2] + 2 * x[:-2, 1:-1] + x[:-2, 2:]))
    return gx, gy


def _nms(mag: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """cv2's sector NMS: compare with the two neighbours along the
    quantised gradient direction (> and >= for the horizontal and vertical
    sectors, > on both sides for the diagonals)."""
    h, w = mag.shape
    m = torch.nn.functional.pad(mag, (1, 1, 1, 1))

    def nb(dy, dx):
        return _shift(m, dy, dx, h, w)

    ax, ay = torch.abs(gx), torch.abs(gy)
    # cv2 canny.cpp: tg22 = 0.4142, tg67 = 2.4142
    horizontal = ay < ax * 0.4142135623730950488016887242097
    vertical = ay > ax * 2.4142135623730950488016887242097
    sign = (gx * gy) >= 0
    n1 = torch.where(horizontal, nb(0, -1), torch.where(
        vertical, nb(-1, 0), torch.where(sign, nb(-1, -1), nb(-1, 1))))
    n2 = torch.where(horizontal, nb(0, 1), torch.where(
        vertical, nb(1, 0), torch.where(sign, nb(1, 1), nb(1, -1))))
    keep_hv = (mag > n1) & (mag >= n2)
    keep_diag = (mag > n1) & (mag > n2)
    return torch.where(horizontal | vertical, keep_hv, keep_diag)


def _grow(a: torch.Tensor, shifts, pad_value: bool = False) -> torch.Tensor:
    """``a`` OR its neighbours at ``shifts``, outside the image ``pad_value``."""
    h, w = a.shape
    p = torch.nn.functional.pad(a, (1, 1, 1, 1), value=pad_value)
    out = a
    for dy, dx in shifts:
        out = out | _shift(p, dy, dx, h, w)
    return out


_N8 = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1) if (dy, dx) != (0, 0)]
_N4 = [(-1, 0), (1, 0), (0, -1), (0, 1)]


def _fixpoint(step, start: torch.Tensor) -> torch.Tensor:
    """Iterate ``step`` from ``start`` until it changes nothing (at most
    the pixel count of steps), reading the changed flag on the host once
    every CHECK_EVERY steps."""
    cur = start
    for _ in range(-(-start.numel() // CHECK_EVERY) + 1):
        before = cur
        for _ in range(CHECK_EVERY):
            cur = step(cur)
        if not bool((cur != before).any()):
            break
    return cur


def canny_edges(img_u8, low: float = 128.0, high: float = 256.0,
                device=None) -> torch.Tensor:
    """``cv2.Canny(img, low, high)`` (L1 gradient, Sobel-3) of one ``[H,
    W]`` image → a bool edge map.  Runs on ``device`` (default the CUDA
    device; raises ``RuntimeError`` without one unless ``device='cpu'``)."""
    dev = _build.resolve_device(device)
    gx, gy = _sobel(torch.as_tensor(img_u8).to(dev))
    mag = torch.abs(gx) + torch.abs(gy)
    keep = _nms(mag, gx, gy)
    strong = keep & (mag > high)
    weak = keep & (mag > low)
    return _fixpoint(lambda cur: _grow(cur, _N8) & weak, strong)


def transition_from_mem(mem_u8, grid_h: int, grid_w: int, cell_h: int,
                        cell_w: int) -> torch.Tensor:
    """default_ptm.py:59-64's transition grid: the full-res mem image
    sampled at cell strides, 255 where |value − 255| ≥ 1, else 0."""
    sampled = torch.as_tensor(mem_u8)[::cell_h, ::cell_w][:grid_h, :grid_w]
    return torch.where(torch.abs(sampled.to(torch.int32) - 255) >= 1, 255, 0).to(torch.uint8)


def canny_roi_boxes(transition_u8, image_h: int, image_w: int, cell_h: int, cell_w: int,
                    k_max: int = 8, device=None) -> dict:
    """Canny → external contours' bounding boxes → pixel ROIs with the
    1-cell extend, clamped like the reference's nine border cases
    (default_ptm.py:71-80).

    Returns ``boxes`` [k_max, 4] (x0, y0, x1, y1) in pixels, ``valid``
    [k_max], ``any_active`` and ``edges``.  Slots follow the components'
    ascending root index.  Runs on ``device`` (default the CUDA device;
    raises ``RuntimeError`` without one unless ``device='cpu'``)."""
    dev = _build.resolve_device(device)
    edges = canny_edges(torch.as_tensor(transition_u8).to(dev).to(torch.float32),
                        device=dev)
    h, w = edges.shape
    # the bboxes of the 8-connected edge sets are the external contours'
    # boundingRects; RETR_EXTERNAL drops contours nested in another
    # component's holes: keep the components 8-adjacent to the background
    # that the border reaches through 4-connected steps
    labels = cc.label_components(edges[None], connectivity=8)[0]
    bg = ~edges
    border = torch.zeros((h, w), dtype=torch.bool, device=dev)
    border[0, :] = border[-1, :] = border[:, 0] = border[:, -1] = True
    outside = _fixpoint(lambda cur: _grow(cur, _N4) & bg, border & bg)
    near_out = _grow(outside, _N8, pad_value=True)
    # an external component: one of its pixels is an edge next to outside
    ext = edges & near_out
    flat = labels.reshape(-1).long()
    root_ext = torch.zeros(h * w, dtype=torch.long, device=dev).scatter_reduce(
        0, flat.clamp(min=0), ext.reshape(-1).long(), "amax")
    stats = cc.component_stats(labels[None], k_max=k_max)
    # slot k holds the k-th root in ascending order (component_stats)
    lin = torch.arange(h * w, device=dev)
    is_root = flat == lin
    rank = torch.cumsum(is_root.long(), 0) - 1
    slot_of_root = torch.where(is_root & (rank < k_max), rank, k_max)
    external = torch.zeros(k_max + 1, dtype=torch.long, device=dev).scatter_reduce(
        0, slot_of_root, root_ext, "amax")[:k_max] > 0

    bx, by, bw, bh = (stats["boxes"][0, :, i] for i in range(4))
    # grid [x0, y0, x1, y1) with the 1-cell extend, then pixels clamped to
    # w-1 / h-1 as the reference does
    px0 = torch.clamp((bx - 1) * cell_w, 0, image_w - 1)
    py0 = torch.clamp((by - 1) * cell_h, 0, image_h - 1)
    px1 = torch.clamp((bx + bw + 1) * cell_w, 0, image_w - 1)
    py1 = torch.clamp((by + bh + 1) * cell_h, 0, image_h - 1)
    valid = stats["valid"][0] & external
    return {
        "boxes": torch.stack([px0, py0, px1, py1], dim=-1),
        "valid": valid,
        "any_active": valid.any(),
        "edges": edges,
    }
