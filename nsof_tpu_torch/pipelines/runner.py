"""Scene runners: dual-path execution + per-stage metrics + CSV reports.

The port's counterpart of :mod:`nsof_tpu.pipelines.runner`.  The reference
runs a Python loop per frame pair with host OpenCV calls and brackets every
stage with ``time.time()`` (module-global lists, optical_flow_seg.py:51-59),
flushing a row per pair into a fixed-schema CSV (:366-382,
optical_flow_ob.py:460-476, optical_flow_prediction.py:410-427) plus a
free-text log.  Here each pair runs the exact per-stage programs of
:mod:`nsof_tpu_torch.pipelines` (``seg_stages``, ``tracking_stages``,
``prediction_stages``) on the device, timed per stage on both the
neuromorphic-ROI path and the full-frame baseline.

Timing: each stage is bracketed by device synchronisations, so its wall
time covers its device work.  ``_dispatch_floor`` measures the constant of
one synchronised trivial operation, and every per-stage time has it
subtracted (clamped at 0), so the CSV columns keep their meaning; the
measured floor is recorded in ``SceneResult.timing`` and the text log.  The
stages are warmed up untimed on pair 0 first, which loads the device
libraries and grows the caching allocator.  For throughput use the batched
paths (``seg_batch_fast`` and friends).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from nsof_tpu_torch import _build
from nsof_tpu_torch.data.scenes import SceneData
from nsof_tpu_torch.ops.ssim import ssim
from nsof_tpu_torch.pipelines import prediction as pred_pipe
from nsof_tpu_torch.pipelines import segmentation as seg_pipe
from nsof_tpu_torch.pipelines import tracking as trk_pipe
from nsof_tpu_torch.utils import reporting
from nsof_tpu_torch.utils.timing import block_until_ready


@dataclasses.dataclass
class SceneResult:
    masks: Optional[np.ndarray] = None
    masks_full: Optional[np.ndarray] = None
    boxes: Optional[np.ndarray] = None
    boxes_valid: Optional[np.ndarray] = None
    boxes_full: Optional[np.ndarray] = None
    boxes_full_valid: Optional[np.ndarray] = None
    preds: Optional[np.ndarray] = None
    preds_full: Optional[np.ndarray] = None
    metrics: dict = dataclasses.field(default_factory=dict)
    timing: dict = dataclasses.field(default_factory=dict)


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _batched(scene: SceneData, dev: torch.device):
    n = scene.num_pairs
    return (n, _upload(scene.mem_gray[1 : n + 1], dev), _upload(scene.frames_gray[:n], dev),
            _upload(scene.frames_gray[1 : n + 1], dev))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _dispatch_floor(dev: torch.device, iters: int = 6) -> float:
    """Median wall time of a trivial synchronised operation on distinct
    inputs — the per-stage constant of the execution environment."""
    xs = [torch.full((8,), float(i), device=dev) for i in range(iters + 2)]
    for i in range(2):
        block_until_ready(xs[i] + 1.0)
    ts = []
    for i in range(iters):
        _sync(dev)
        t0 = time.perf_counter()
        block_until_ready(xs[2 + i] + 1.0)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


class _Timed:
    """Runs stage programs, accumulating floor-subtracted wall seconds per
    stage name; the device is synchronised at both ends of each stage."""

    def __init__(self, floor: float, dev: torch.device):
        self.floor = floor
        self.dev = dev
        self.acc: dict[str, list[float]] = {}
        self.last: dict[str, float] = {}

    def __call__(self, name: str, fn, *args):
        _sync(self.dev)
        t0 = time.perf_counter()
        out = block_until_ready(fn(*args))
        dt = max(0.0, time.perf_counter() - t0 - self.floor)
        self.acc.setdefault(name, []).append(dt)
        self.last[name] = dt
        return out

    def totals(self) -> dict[str, float]:
        return {k: float(np.sum(v)) for k, v in self.acc.items()}


def _flow_row(names_pair, tm: _Timed) -> dict:
    """The four shared flow-time CSV columns + per-stage strings."""
    orig = tm.last.get("vel_full", 0.0)
    mem = tm.last.get("cal", 0.0) + tm.last.get("vel", 0.0)
    imp = orig - mem
    return {
        "Frame_Pair": names_pair,
        "Original_Flow_Time": f"{orig:.4f}",
        "Mem_Flow_Time": f"{mem:.4f}",
        "Flow_Time_Improvement": f"{imp:.4f}",
        "Flow_Time_Improvement_Percent": (
            f"{100 * imp / max(orig, 1e-9):.2f}"
        ),
        "Cal_Times": f"{tm.last.get('cal', 0.0):.4f}",
        "Velocity_Times": f"{tm.last.get('vel', 0.0):.4f}",
    }


def _timing_summary(tm: _Timed, n: int) -> dict:
    t = tm.totals()
    roi = sum(t.get(k, 0.0) for k in ("cal", "vel", "task", "comb"))
    full = sum(t.get(k, 0.0) for k in ("vel_full", "task_full"))
    return {
        "dispatch_floor_s": tm.floor,
        "roi_s_total": roi,
        "full_s_total": full,
        "roi_ms_per_pair": 1e3 * roi / n,
        "full_ms_per_pair": 1e3 * full / n,
        "stage_totals_s": t,
    }


def _reports(csv_path, txt_path, columns, tm: _Timed):
    report = reporting.CsvReport(csv_path, columns) if csv_path else None
    log = reporting.TextLog(txt_path) if txt_path else None
    if log:
        log.write(f"dispatch_floor_s={tm.floor:.4f}")
    return report, log


def run_segmentation(
    scene: SceneData,
    csv_path: Optional[str] = None,
    txt_path: Optional[str] = None,
    collect: bool = True,
    device=None,
) -> SceneResult:
    """Dual-path motion segmentation over a whole scene, stage-timed per
    pair with the reference CSV schema (optical_flow_seg.py:366-382).

    ``collect=False`` skips the per-pair mask downloads (the metrics are
    computed on the device either way).  Runs on ``device`` (default the
    CUDA device; raises ``RuntimeError`` without one unless
    ``device='cpu'``)."""
    dev = _build.resolve_device(device)
    cfg = scene.cfg
    n, mem, prev, nxt = _batched(scene, dev)
    st = seg_pipe.seg_stages(cfg, device=dev)
    tm = _Timed(_dispatch_floor(dev), dev)
    report, log = _reports(csv_path, txt_path, reporting.SEG_COLUMNS, tm)

    gt = scene.gt_masks[1 : n + 1] if scene.gt_masks is not None else None
    gt_dev = _upload(gt, dev) if gt is not None else None

    # warm the stages up untimed on pair 0
    roi0 = st["cal"](mem[0])
    fw0, ib0 = st["vel"](prev[0], nxt[0], mem[0], roi0)
    mw0 = st["task"](fw0, ib0)
    block_until_ready(st["comb"](mw0, roi0["box"], roi0["origin"]))
    block_until_ready(st["task_full"](st["vel_full"](prev[0], nxt[0])))

    masks, masks_full, pa_roi, pa_full = [], [], [], []
    for i in range(n):
        roi = tm("cal", st["cal"], mem[i])
        flow_win, inbox = tm(
            "vel", st["vel"], prev[i], nxt[i], mem[i], roi
        )
        mask_win = tm("task", st["task"], flow_win, inbox)
        mask = tm("comb", st["comb"], mask_win, roi["box"], roi["origin"])
        flow_full = tm("vel_full", st["vel_full"], prev[i], nxt[i])
        mask_full = tm("task_full", st["task_full"], flow_full)
        if collect:
            masks.append(mask.cpu().numpy())
            masks_full.append(mask_full.cpu().numpy())

        row = _flow_row(f"{scene.names[i+1]}-{scene.names[i]}", tm)
        row.update(
            {
                "Original_Seg_Time": f"{tm.last['task_full']:.4f}",
                "Mem_Seg_Time": f"{tm.last['task']:.4f}",
                "Combination_Time": f"{tm.last['comb']:.4f}",
                "Region_Percent": f"{float(roi['region_pct']):.2f}",
            }
        )
        if gt_dev is not None:
            pa_roi.append(float(seg_pipe.pixel_accuracy(mask, gt_dev[i])))
            pa_full.append(float(seg_pipe.pixel_accuracy(mask_full, gt_dev[i])))
            row["Original_PA"] = f"{pa_full[-1]:.4f}"
            row["Mem_PA"] = f"{pa_roi[-1]:.4f}"
        if report:
            report.add(row)
        if log:
            log.write(
                f"{row['Frame_Pair']}: flow orig={row['Original_Flow_Time']}"
                f" mem={row['Mem_Flow_Time']} pa_orig="
                f"{row.get('Original_PA', '-')} pa_mem="
                f"{row.get('Mem_PA', '-')}"
            )

    res = SceneResult(
        masks=np.stack(masks) if masks else None,
        masks_full=np.stack(masks_full) if masks_full else None,
    )
    res.timing = _timing_summary(tm, n)
    if gt is not None:
        res.metrics = {
            "mem_pa_mean": float(np.mean(pa_roi)),
            "orig_pa_mean": float(np.mean(pa_full)),
        }
    return res


def run_tracking(
    scene: SceneData,
    csv_path: Optional[str] = None,
    txt_path: Optional[str] = None,
    device=None,
) -> SceneResult:
    """Dual-path object tracking; per-pair IoU vs the GT max bbox on both
    paths, reference CSV schema (optical_flow_ob.py:460-476).  Runs on
    ``device`` (default the CUDA device; raises ``RuntimeError`` without one
    unless ``device='cpu'``)."""
    dev = _build.resolve_device(device)
    cfg = scene.cfg
    n, mem, prev, nxt = _batched(scene, dev)
    st = trk_pipe.tracking_stages(cfg, device=dev)
    tm = _Timed(_dispatch_floor(dev), dev)
    report, log = _reports(csv_path, txt_path, reporting.OB_COLUMNS, tm)

    # the per-pair GT max-bboxes, up front
    gt_boxes = gt_found = None
    if scene.gt_masks is not None:
        gt_boxes, gt_found = [], []
        for i in range(n):
            b, f = trk_pipe.max_bbox_from_mask(_upload(scene.gt_masks[i + 1], dev))
            gt_boxes.append(b)
            gt_found.append(bool(f))

    # warm the stages up untimed on pair 0 (see run_segmentation)
    roi0 = st["cal"](mem[0])
    fw0, ib0 = st["vel"](prev[0], nxt[0], mem[0], roi0)
    block_until_ready(
        st["task"](fw0, ib0, roi0["origin"], roi0["active"])
    )
    block_until_ready(st["task_full"](st["vel_full"](prev[0], nxt[0])))

    boxes, valids, boxes_f, valids_f = [], [], [], []
    ious, ious_f = [], []
    for i in range(n):
        roi = tm("cal", st["cal"], mem[i])
        flow_win, inbox = tm(
            "vel", st["vel"], prev[i], nxt[i], mem[i], roi
        )
        out = tm(
            "task", st["task"], flow_win, inbox, roi["origin"],
            roi["active"],
        )
        flow_full = tm("vel_full", st["vel_full"], prev[i], nxt[i])
        out_f = tm("task_full", st["task_full"], flow_full)
        boxes.append(out["boxes"].cpu().numpy())
        valids.append(out["valid"].cpu().numpy())
        boxes_f.append(out_f["boxes"].cpu().numpy())
        valids_f.append(out_f["valid"].cpu().numpy())

        row = _flow_row(f"{scene.names[i+1]}-{scene.names[i]}", tm)
        row.update(
            {
                "Original_OB_Time": f"{tm.last['task_full']:.4f}",
                "Mem_OB_Time": f"{tm.last['task']:.4f}",
                "Combination_Time": "0.0000",  # box offset folded into task
                "Region_Percent": f"{float(roi['region_pct']):.2f}",
            }
        )
        if gt_boxes is not None and gt_found[i]:
            iou = float(trk_pipe.mean_iou_vs_gt(out["boxes"], out["valid"], gt_boxes[i]))
            iou_f = float(
                trk_pipe.mean_iou_vs_gt(out_f["boxes"], out_f["valid"], gt_boxes[i])
            )
            ious.append(iou)
            ious_f.append(iou_f)
            row["Mem_IoU"] = f"{iou:.4f}"
            row["Original_IoU"] = f"{iou_f:.4f}"
        if report:
            report.add(row)
        if log:
            log.write(
                f"{row['Frame_Pair']}: iou mem={row.get('Mem_IoU', '-')}"
                f" orig={row.get('Original_IoU', '-')}"
            )

    res = SceneResult(
        boxes=np.stack(boxes),
        boxes_valid=np.stack(valids),
        boxes_full=np.stack(boxes_f),
        boxes_full_valid=np.stack(valids_f),
    )
    res.timing = _timing_summary(tm, n)
    if ious:
        res.metrics = {
            "mean_iou": float(np.mean(ious)),
            "mean_iou_full": float(np.mean(ious_f)),
        }
    return res


def run_prediction(
    scene: SceneData,
    csv_path: Optional[str] = None,
    txt_path: Optional[str] = None,
    collect: bool = True,
    device=None,
) -> SceneResult:
    """Dual-path future-frame prediction; per-pair SSIM vs true frame i+2
    on both paths, reference CSV schema
    (optical_flow_prediction.py:410-427).

    SSIM runs on the device against a once-uploaded channel-2 stack of the
    true future frames; ``collect=False`` skips the per-pair predicted-frame
    downloads.  Runs on ``device`` (default the CUDA device; raises
    ``RuntimeError`` without one unless ``device='cpu'``)."""
    dev = _build.resolve_device(device)
    cfg = scene.cfg
    n, mem, prev, nxt = _batched(scene, dev)
    nxt_bgr = _upload(scene.frames_bgr[1 : n + 1], dev)
    # channel 2 of the true future frame is all the SSIM metric reads
    # (optical_flow_prediction.py:113-115)
    true_r = _upload(scene.frames_bgr[2 : n + 2, :, :, 2], dev)

    def pred_ssim(p, t):
        return ssim(t, p[..., 2], data_range=255.0)

    st = pred_pipe.prediction_stages(cfg, device=dev)
    tm = _Timed(_dispatch_floor(dev), dev)
    report, log = _reports(csv_path, txt_path, reporting.PRED_COLUMNS, tm)

    # warm the stages up untimed on pair 0 (see run_segmentation)
    roi0 = st["cal"](mem[0])
    fw0, _ = st["vel"](prev[0], nxt[0], mem[0], roi0)
    fl0 = st["comb"](fw0, roi0["box"], roi0["origin"])
    p0 = st["task"](nxt_bgr[0], fl0, roi0["box"], roi0["active"])
    block_until_ready(pred_ssim(p0, true_r[0]))
    block_until_ready(
        st["task_full"](nxt_bgr[0], st["vel_full"](prev[0], nxt[0]))
    )

    preds, preds_f, ssims, ssims_f = [], [], [], []
    for i in range(n):
        roi = tm("cal", st["cal"], mem[i])
        flow_win, _ = tm(
            "vel", st["vel"], prev[i], nxt[i], mem[i], roi
        )
        flow = tm("comb", st["comb"], flow_win, roi["box"], roi["origin"])
        pred = tm(
            "task", st["task"], nxt_bgr[i], flow, roi["box"], roi["active"]
        )
        flow_full = tm("vel_full", st["vel_full"], prev[i], nxt[i])
        pred_f = tm("task_full", st["task_full"], nxt_bgr[i], flow_full)
        if collect:
            preds.append(pred.cpu().numpy())
            preds_f.append(pred_f.cpu().numpy())

        ssims.append(float(pred_ssim(pred, true_r[i])))
        ssims_f.append(float(pred_ssim(pred_f, true_r[i])))

        row = _flow_row(f"{scene.names[i+1]}-{scene.names[i]}", tm)
        row.update(
            {
                "Original_Pred_Time": f"{tm.last['task_full']:.4f}",
                "Mem_Pred_Time": f"{tm.last['task']:.4f}",
                "Combination_Time": f"{tm.last['comb']:.4f}",
                "Original_SSIM": f"{ssims_f[-1]:.4f}",
                "Mem_SSIM": f"{ssims[-1]:.4f}",
                "Region_Percent": f"{float(roi['region_pct']):.2f}",
            }
        )
        if report:
            report.add(row)
        if log:
            log.write(
                f"{row['Frame_Pair']}: ssim mem={row['Mem_SSIM']}"
                f" orig={row['Original_SSIM']}"
            )

    res = SceneResult(
        preds=np.stack(preds) if preds else None,
        preds_full=np.stack(preds_f) if preds_f else None,
    )
    res.timing = _timing_summary(tm, n)
    res.metrics = {
        "mean_ssim": float(np.mean(ssims)),
        "mean_ssim_full": float(np.mean(ssims_f)),
    }
    return res
