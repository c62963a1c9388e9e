"""Benchmark evaluation and submission writers (codebase/RAFT/evaluate.py):
the port of :mod:`nsof_tpu.train.evaluate`.

- validate_* : EPE (and KITTI F1) over standard splits.
- create_sintel_submission / create_kitti_submission : write the flow
  files in each benchmark's upload format (.flo folders / 16-bit pngs),
  mirroring evaluate.py:21-60.

``flow_fn(img1 [1,H,W,3], img2) -> flow [1,H,W,2]`` is any flow backend
(RAFT, FlowFormer, or the Farnebäck op) on float32 numpy frames; it may
return a tensor on any device.  Padded/unpadded by the caller or via the
helper below.  Frames are read by the port's PNG and PPM codecs.
"""

from __future__ import annotations

import pathlib
from typing import Callable, Iterable

import numpy as np
import torch

from nsof_tpu_torch.data import flow_datasets as fd


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pad8_np(img: np.ndarray):
    h, w = img.shape[1:3]
    ph = (-h) % 8
    pw = (-w) % 8
    pads = ((0, 0), (ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2),
            (0, 0))
    return np.pad(img, pads, mode="edge"), pads


def run_padded(flow_fn: Callable, img1: np.ndarray, img2: np.ndarray):
    """Pad to /8, run, unpad (InputPadder semantics)."""
    p1, pads = _pad8_np(img1)
    p2, _ = _pad8_np(img2)
    flow = _numpy(flow_fn(p1, p2))
    t, l = pads[1][0], pads[2][0]
    h, w = img1.shape[1:3]
    return flow[:, t : t + h, l : l + w]


def _frames(pair: fd.FlowPair):
    return (fd.read_image(pair.img1_path)[None].astype(np.float32),
            fd.read_image(pair.img2_path)[None].astype(np.float32))


def validate_pairs(
    flow_fn: Callable,
    pairs: Iterable[fd.FlowPair],
    max_pairs: int | None = None,
) -> dict:
    """Mean EPE + KITTI-style F1 (err>3px and >5% of magnitude) over
    ground-truthed pairs."""
    epes, out_frac = [], []
    for i, pair in enumerate(pairs):
        if max_pairs is not None and i >= max_pairs:
            break
        if pair.flow_path is None:
            continue
        gt, valid = fd.read_flow_any(pair.flow_path)
        pred = run_padded(flow_fn, *_frames(pair))[0]
        err = np.sqrt(((pred - gt) ** 2).sum(-1))
        mag = np.sqrt((gt**2).sum(-1))
        if valid is None:
            valid = np.ones(err.shape, bool)
        epes.append(err[valid].mean())
        out = (err > 3.0) & (err / np.maximum(mag, 1e-9) > 0.05)
        out_frac.append(out[valid].mean())
    return {
        "epe": float(np.mean(epes)) if epes else float("nan"),
        "f1": 100.0 * float(np.mean(out_frac)) if out_frac else float("nan"),
        "n": len(epes),
    }


def create_sintel_submission(
    flow_fn: Callable, root, out_dir, dstype: str = "clean"
) -> int:
    """Write frame_%04d.flo per scene (evaluate.py create_sintel_submission)."""
    out_dir = pathlib.Path(out_dir) / dstype
    n = 0
    pairs = fd.scan_sintel(root, split="test", dstype=dstype)
    for pair in pairs:
        scene = pathlib.Path(pair.img1_path).parent.name
        idx = int(pathlib.Path(pair.img1_path).stem.split("_")[-1])
        flow = run_padded(flow_fn, *_frames(pair))[0]
        d = out_dir / scene
        d.mkdir(parents=True, exist_ok=True)
        fd.write_flo(d / f"frame_{idx:04d}.flo", flow)
        n += 1
    return n


def create_kitti_submission(flow_fn: Callable, root, out_dir) -> int:
    """Write KITTI 16-bit png flow files (evaluate.py create_kitti_submission)."""
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    n = 0
    for pair in fd.scan_kitti(root, split="testing"):
        flow = run_padded(flow_fn, *_frames(pair))[0]
        name = pathlib.Path(pair.img1_path).name
        fd.write_kitti_flow(out_dir / name, flow)
        n += 1
    return n
