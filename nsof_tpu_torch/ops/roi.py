"""Neuromorphic ROI extraction, batched over B.

Counterpart of :mod:`nsof_tpu.ops.roi`: threshold the device-state maps,
find their connected active regions, derive per-component boxes and the
merged union box in image coordinates, and crop / scatter a static-size
window at each sample's origin.  Every function takes the batch as its
leading dimension instead of being vmapped.

The batched crop :func:`crop_windows_batch` is kernel K1 (``csrc/
crop_windows.cu``).  It crops at the exact origins: the JAX package floors
them to the (32, 128) uint8 tiling only on the TPU, where Mosaic's DMA
requires it; its CPU path, like this one, uses the origins as given.
The seg step's scatter of its mask and flow windows into their frames,
:func:`scatter_seg_windows`, is kernel K13 (``csrc/scatter_window.cu``);
:func:`scatter_window`, the plain scatter of one window, stays as it is for
the exact path, the deep path and the other heads.
"""

from __future__ import annotations

import dataclasses

import torch

from nsof_tpu_torch import _build
from nsof_tpu_torch.ops.components import connected_components_with_stats


@dataclasses.dataclass(frozen=True)
class RoiConfig:
    """Per-dataset ROI parameters (data/*/Parameters.txt)."""

    memsize: int = 80  # image px per device cell (MEMSIZE)
    thres: int = 250  # activity threshold on the uint8 state map (THRES)
    extend_left: int = 20  # EXTEND_WIDTH_LEFT
    extend_right: int = 20  # EXTEND_WIDTH_RIGHT
    extend_up: int = 20  # EXTEND_HEIGHT_UPPER
    extend_down: int = 20  # EXTEND_HEIGHT_LOWER
    connectivity: int = 4  # CONNECT
    mode: int = 2  # FLAG: 1 = separate regions, 2 = merged union box
    padding: int = 20  # PADDING applied by the task heads
    k_max: int = 16  # static slots for separate regions


def transition_map(mem_u8: torch.Tensor, thres: int) -> torch.Tensor:
    """Binary activity map: 255 where state ≥ thres, else 0 (uint8)."""
    return (mem_u8 >= thres).to(torch.uint8) * 255


def _clamp_box(x0, y0, x1, y1, w, h):
    return x0.clamp(min=0), y0.clamp(min=0), x1.clamp(max=w), y1.clamp(max=h)


def roi_boxes(
    mem_u8: torch.Tensor, image_h: int, image_w: int, cfg: RoiConfig
) -> dict:
    """Threshold → connected components → image-space ROI boxes for
    ``[B, gh, gw]`` state maps.

    Returns ``boxes`` [B, k_max, 4] int32 (x_start, y_start, x_end, y_end,
    end exclusive, scaled by memsize, EXTEND-padded, clamped), ``valid``
    [B, k_max], ``merged`` [B, 4] int32 union box (FLAG=2), ``any_active``
    [B] bool, ``transition`` and ``labels``.
    """
    tp = transition_map(mem_u8, cfg.thres)
    cc = connected_components_with_stats(tp, cfg.connectivity, cfg.k_max)
    grid = cc["boxes"]  # (x, y, w, h) in grid cells
    valid = cc["valid"]
    px = py = cfg.memsize
    x0, y0, x1, y1 = _clamp_box(
        grid[..., 0] * px - cfg.extend_left,
        grid[..., 1] * py - cfg.extend_up,
        (grid[..., 0] + grid[..., 2]) * px + cfg.extend_right,
        (grid[..., 1] + grid[..., 3]) * py + cfg.extend_down,
        image_w, image_h,
    )
    boxes = torch.stack([x0, y0, x1, y1], dim=-1)
    boxes = torch.where(valid[..., None], boxes, torch.zeros_like(boxes))

    # merged box: the union of all component boxes is the bbox of the
    # active mask, padded after the union (process_merged_region)
    active = tp > 0
    b, gh, gw = active.shape
    dev = active.device
    big = 2**30
    cols = torch.arange(gw, dtype=torch.int32, device=dev).expand(gh, gw)
    rows = torch.arange(gh, dtype=torch.int32, device=dev)[:, None].expand(gh, gw)

    def reduce(vals, fill, op):
        v = torch.where(active, vals, torch.full_like(vals, fill))
        return getattr(v.reshape(b, -1), op)(dim=1)

    mx0, my0, mx1, my1 = _clamp_box(
        reduce(cols, big, "amin") * px - cfg.extend_left,
        reduce(rows, big, "amin") * py - cfg.extend_up,
        reduce(cols + 1, -big, "amax") * px + cfg.extend_right,
        reduce(rows + 1, -big, "amax") * py + cfg.extend_down,
        image_w, image_h,
    )
    any_active = valid.any(dim=1)
    merged = torch.stack([mx0, my0, mx1, my1], dim=-1)
    merged = torch.where(any_active[:, None], merged, torch.zeros_like(merged))
    return {
        "boxes": boxes.to(torch.int32),
        "valid": valid,
        "merged": merged.to(torch.int32),
        "any_active": any_active,
        "transition": tp,
        "labels": cc["labels"],
    }


def window_origin(box: torch.Tensor, win_h: int, win_w: int, image_h: int,
                  image_w: int):
    """Top-left of a fixed-size window containing each ``[..., 4]`` box,
    clamped in-image; returns int32 (oy, ox)."""
    oy = box[..., 1].clamp(0, max(image_h - win_h, 0))
    ox = box[..., 0].clamp(0, max(image_w - win_w, 0))
    return oy.to(torch.int32), ox.to(torch.int32)


def _clamped_origins(oys, oxs, h, w, win_h, win_w):
    """dynamic_slice semantics: a negative start counts from the end, then
    starts are clamped so the window fits."""
    oy, ox = oys.long(), oxs.long()
    oy = torch.where(oy < 0, oy + h, oy).clamp(0, h - win_h)
    ox = torch.where(ox < 0, ox + w, ox).clamp(0, w - win_w)
    return oy, ox


def crop_windows(frames: torch.Tensor, oys: torch.Tensor, oxs: torch.Tensor,
                 win_h: int, win_w: int) -> torch.Tensor:
    """Batched static-size crop by indexing, with no kernel: the exact
    path's crop and the plain version of K1 (:func:`crop_windows_batch`).
    Origins are clamped so the window fits, as dynamic_slice does."""
    b, h, w = frames.shape[:3]
    oy, ox = _clamped_origins(oys, oxs, h, w, win_h, win_w)
    dev = frames.device
    rows = oy[:, None, None] + torch.arange(win_h, device=dev)[None, :, None]
    cols = ox[:, None, None] + torch.arange(win_w, device=dev)[None, None, :]
    bi = torch.arange(b, device=dev)[:, None, None]
    return frames[bi, rows, cols]


def crop_window(img: torch.Tensor, origin_yx, win_h: int, win_w: int):
    """Static-size crop of one ``[H, W(, C)]`` image at ``origin_yx``
    (ints or 0-dim tensors): :func:`crop_windows` on a batch of one."""
    oy, ox = (torch.as_tensor(o, device=img.device).reshape(1) for o in origin_yx)
    return crop_windows(img[None], oy, ox, win_h, win_w)[0]


def _crop_windows_cuda(frames, oys, oxs, win_h, win_w):
    b, h, w = frames.shape[:3]
    if not frames.is_contiguous():
        raise ValueError("crop_windows_batch: frames must be contiguous")
    if win_h > h or win_w > w:
        raise ValueError(f"window {win_h}x{win_w} exceeds frame {h}x{w}")
    oys = oys.to(device=frames.device, dtype=torch.int32).contiguous()
    oxs = oxs.to(device=frames.device, dtype=torch.int32).contiguous()
    if oys.shape != (b,) or oxs.shape != (b,):
        raise ValueError("crop_windows_batch: origins must be [B]")
    out = torch.empty((b, win_h, win_w) + tuple(frames.shape[3:]),
                      dtype=frames.dtype, device=frames.device)
    elem = frames.element_size()
    for d in frames.shape[3:]:
        elem *= d
    stream = torch.cuda.current_stream(frames.device).cuda_stream
    fn = _build.launcher("crop_windows", 4, 6)
    _build.check(fn(
        frames.data_ptr(), oys.data_ptr(), oxs.data_ptr(), out.data_ptr(),
        b, h, w, win_h, win_w, elem, stream,
    ), "crop_windows")
    _build.LAUNCHES["crop_windows"] += 1
    return out


def crop_windows_batch(
    frames: torch.Tensor, oys: torch.Tensor, oxs: torch.Tensor,
    win_h: int, win_w: int,
) -> torch.Tensor:
    """Batched static-size crop: ``[B, H, W(, C)]`` frames + per-sample
    origins → windows ``[B, win_h, win_w(, C)]``.

    A CUDA tensor goes through kernel K1; a CPU tensor through the plain
    version, :func:`crop_windows`.  Origins are clamped so the window fits, as dynamic_slice
    does.
    """
    if frames.is_cuda:
        return _crop_windows_cuda(frames, oys, oxs, win_h, win_w)
    return crop_windows(frames, oys, oxs, win_h, win_w)


def window_box_mask(box: torch.Tensor, oys: torch.Tensor, oxs: torch.Tensor,
                    win_h: int, win_w: int) -> torch.Tensor:
    """Boolean ``[B, win_h, win_w]`` mask of window pixels inside each
    sample's ``box`` ([B, 4])."""
    dev = box.device
    ys = torch.arange(win_h, device=dev)[None, :, None] + oys[:, None, None]
    xs = torch.arange(win_w, device=dev)[None, None, :] + oxs[:, None, None]
    bx = box[:, :, None, None]
    return (ys >= bx[:, 1]) & (ys < bx[:, 3]) & (xs >= bx[:, 0]) & (xs < bx[:, 2])


def scatter_window(full: torch.Tensor, window: torch.Tensor, box: torch.Tensor,
                   oys: torch.Tensor, oxs: torch.Tensor) -> torch.Tensor:
    """Write each sample's window into ``full`` ([B, H, W(, C)]) only
    inside its ``box``; returns a new tensor."""
    b, h, w = full.shape[:3]
    win_h, win_w = window.shape[1:3]
    # as in the JAX package: the mask from the origins as given, the
    # write at the clamped ones (dynamic_update_slice semantics)
    mask = window_box_mask(box, oys, oxs, win_h, win_w)
    oy, ox = _clamped_origins(oys, oxs, h, w, win_h, win_w)
    if window.ndim == 4:
        mask = mask[..., None]
    dev = full.device
    rows = oy[:, None, None] + torch.arange(win_h, device=dev)[None, :, None]
    cols = ox[:, None, None] + torch.arange(win_w, device=dev)[None, None, :]
    bi = torch.arange(b, device=dev)[:, None, None]
    out = full.clone()
    out[bi, rows, cols] = torch.where(mask, window, full[bi, rows, cols])
    return out


def scatter_seg_windows_plain(mask_win, dx, dy, box, active, oys, oxs, h: int, w: int,
                              return_flow: bool):
    """Plain version of K13 (:func:`scatter_seg_windows`): the mask window
    into a zero frame, and with ``return_flow`` the negated flow, zeroed
    outside the box and for inactive samples, into another, each through
    :func:`scatter_window`."""
    b = mask_win.shape[0]
    dev = mask_win.device
    mask = scatter_window(torch.zeros((b, h, w), dtype=torch.uint8, device=dev), mask_win,
                          box, oys, oxs)
    if not return_flow:
        return mask, None
    inbox = window_box_mask(box, oys, oxs, *mask_win.shape[1:]) & active[:, None, None]
    # negated (optical_flow_seg.py:461), zero outside the box
    flow_win = torch.stack([-dx, -dy], dim=-1)
    flow_win = torch.where(inbox[..., None], flow_win, torch.zeros_like(flow_win))
    flow = scatter_window(torch.zeros((b, h, w, 2), dtype=torch.float32, device=dev),
                          flow_win, box, oys, oxs)
    return mask, flow


# K13's limit on a frame's pixels: it divides offsets below 2**31 by H·W
SCATTER_MAX_FRAME_PIXELS = 2**30


def _check_scatter_args(mask_win, dx, dy, box, active, oys, oxs, h, w, return_flow):
    """Raise ``ValueError`` for what K13 does not take (on either device, so
    that both refuse alike)."""
    if mask_win.dim() != 3 or mask_win.dtype != torch.uint8:
        raise ValueError(f"scatter: mask_win must be uint8 [B, wh, ww], got {mask_win.dtype} "
                         f"{tuple(mask_win.shape)}")
    b, wh, ww = mask_win.shape
    dev = mask_win.device
    if not mask_win.is_contiguous():
        raise ValueError("scatter: mask_win must be contiguous")
    if wh > h or ww > w:
        raise ValueError(f"scatter: window {wh}x{ww} exceeds frame {h}x{w}")
    if h * w > SCATTER_MAX_FRAME_PIXELS:
        raise ValueError(f"scatter: frame {h}x{w} beyond {SCATTER_MAX_FRAME_PIXELS} pixels")
    for name, t, dtype, shape in (("box", box, torch.int32, (b, 4)),
                                  ("oys", oys, torch.int32, (b,)),
                                  ("oxs", oxs, torch.int32, (b,)),
                                  ("active", active, torch.bool, (b,))):
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"scatter: {name} must be {dtype} {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"scatter: {name} must be contiguous")
    if not return_flow:
        return
    for name, t in (("dx", dx), ("dy", dy)):
        if t.dtype != torch.float32 or tuple(t.shape) != (b, wh, ww) or t.device != dev:
            raise ValueError(f"scatter: {name} must be float32 {(b, wh, ww)} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if dx.stride() != dy.stride() or (ww > 1 and dx.stride(2) != 1):
        raise ValueError("scatter: dx and dy must share strides, each row contiguous")
    if max(dx.stride()) >= 2**31:
        raise ValueError(f"scatter: dx strides {dx.stride()} too large")


def _scatter_seg_windows_cuda(mask_win, dx, dy, box, active, oys, oxs, h, w, return_flow):
    b, wh, ww = mask_win.shape
    dev = mask_win.device
    mask = torch.empty((b, h, w), dtype=torch.uint8, device=dev)
    flow = (torch.empty((b, h, w, 2), dtype=torch.float32, device=dev) if return_flow
            else None)
    fn = _build.launcher("scatter_window", 9, 7)
    _build.check(fn(
        mask_win.data_ptr(), dx.data_ptr() if return_flow else None,
        dy.data_ptr() if return_flow else None, box.data_ptr(), oys.data_ptr(),
        oxs.data_ptr(), active.data_ptr(), mask.data_ptr(),
        flow.data_ptr() if return_flow else None, b, h, w, wh, ww,
        dx.stride(0) if return_flow else 0, dx.stride(1) if return_flow else 0,
        torch.cuda.current_stream(dev).cuda_stream,
    ), "scatter_window")
    _build.LAUNCHES["scatter_window"] += 1
    return mask, flow


def scatter_seg_windows(mask_win, dx, dy, box, active, oys, oxs, h: int, w: int,
                        return_flow: bool):
    """K13, the seg step's scatter: the head's ``[B, wh, ww]`` uint8 mask
    windows → the ``[B, h, w]`` mask frame, and with ``return_flow`` the flow
    planes ``dx``, ``dy`` ``[B, wh, ww]`` → the ``[B, h, w, 2]`` frame of
    (−dx, −dy), zero outside each ``box`` ``[B, 4]`` and for samples not
    ``active``; each window is placed at its origin (``oys``, ``oxs``,
    clamped as dynamic_slice does).  Returns ``(mask, flow or None)``.

    Bit for bit :func:`scatter_seg_windows_plain`, which a CPU tensor takes;
    a CUDA tensor launches K13 (``csrc/scatter_window.cu``) once.  Raises
    ``ValueError`` for inputs K13 does not take (see
    :func:`_check_scatter_args`)."""
    _check_scatter_args(mask_win, dx, dy, box, active, oys, oxs, h, w, return_flow)
    if mask_win.is_cuda:
        return _scatter_seg_windows_cuda(mask_win, dx, dy, box, active, oys, oxs, h, w,
                                         return_flow)
    return scatter_seg_windows_plain(mask_win, dx, dy, box, active, oys, oxs, h, w,
                                     return_flow)


def region_percentage(box: torch.Tensor, image_h: int, image_w: int):
    """ROI area as % of the image, float32, for ``[..., 4]`` boxes."""
    area = (box[..., 2] - box[..., 0]).clamp(min=0) * (
        box[..., 3] - box[..., 1]).clamp(min=0)
    return 100.0 * area.to(torch.float32) / float(image_h * image_w)


def as_batch(tree, device):
    """One sample as a batch of one: every tensor or array of ``tree`` (a
    tensor, or a tuple or dict of them) on ``device`` with a leading
    dimension of 1 (the single-sample entry points call the batched
    functions through it)."""
    if isinstance(tree, dict):
        return {k: as_batch(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(as_batch(v, device) for v in tree)
    return torch.as_tensor(tree).to(device)[None]


def first(tree):
    """Sample 0 of every tensor of a batched ``tree`` (the inverse of
    :func:`as_batch`)."""
    if isinstance(tree, dict):
        return {k: first(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(first(v) for v in tree)
    return tree[0]
