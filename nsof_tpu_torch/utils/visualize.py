"""Visualisation of event-simulation results: the port of
:mod:`nsof_tpu.utils.visualize` (``eventsim/visualize_npz_keyframes.py``).

Given a result npz (``w_final`` + decimated ``resistances`` history, as
written by :func:`nsof_tpu_torch.device.io.save_sim_npz`) it renders

- a final-state image (viridis, scaled to its own range),
- keyframes every N animation frames with a ``manifest.json``,
- an MP4 animation,
- a colorbar image with the animation's colormap,

in resistance space or state space (w = 1 − ln(R/Ron)/λ), with ``abs`` /
``delta`` / ``rel`` modes and optional log10 scaling.

The port needs neither matplotlib nor OpenCV for the images: every PNG is
written by :mod:`nsof_tpu_torch.utils.png`, through the 256-entry tables of
:mod:`nsof_tpu_torch.utils.colormaps`.  A keyframe is ``plt.imsave``'s
RGBA image bit for bit (its normalisation, × 256, clip, truncation, the
byte table); ``w_final`` and the colorbar are the colormapped arrays alone,
where the JAX package draws a matplotlib figure with axes, a title and a
labelled colorbar.  The MP4 writers import OpenCV inside the call and raise
``RuntimeError`` naming it where it is not installed.
"""

from __future__ import annotations

import gzip
import json
import pathlib
from typing import Optional

import numpy as np

from nsof_tpu_torch.utils.colormaps import INFERNO_RGB, JET_BGR, VIRIDIS_RGB
from nsof_tpu_torch.utils.png import encode_png


def load_metadata(npz_path: pathlib.Path) -> dict:
    meta_path = npz_path.with_suffix(".json.gz")
    if not meta_path.exists():
        return {}
    try:
        with gzip.open(meta_path, "rt") as fp:
            return json.load(fp)
    except (OSError, EOFError, ValueError):
        return {}


def resistance_to_state(r: np.ndarray, ron: float, roff: float) -> np.ndarray:
    """w = 1 − ln(R/Ron)/λ, λ = ln(Roff/Ron)."""
    lam = float(np.log(roff / ron))
    return 1.0 - np.log(np.maximum(r / ron, 1e-30)) / lam


def require_cv2(what: str):
    """OpenCV, or ``RuntimeError`` naming it and ``what`` needs it."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            f"{what} needs OpenCV (cv2), which is not installed; pass --no-video "
            "(eventsim) or leave out --mp4 (visualize)") from e
    return cv2


def _render_frame_u8(frame, vmin, vmax):
    """OpenCV's JET of the frame scaled to [vmin, vmax] (BGR, as
    ``cv2.applyColorMap`` gives it)."""
    norm = (frame - vmin) / (vmax - vmin + 1e-12)
    u8 = np.clip(norm * 255.0, 0, 255).astype(np.uint8)
    return JET_BGR[u8]


def colormap_rgba(x: np.ndarray, table: np.ndarray, vmin: float, vmax: float) -> np.ndarray:
    """``plt.imsave``'s RGBA bytes of ``x`` under ``table``: matplotlib's
    ``Normalize`` (float64 scalars on the array's own float type, in place)
    and ``Colormap.__call__(bytes=True)`` (× 256, 1.0 to the last entry,
    truncation; below 0 the first entry, above 1 the last, NaN (0, 0, 0,
    0))."""
    # float32 and float64 kept; integers of ≤ 2 bytes to float32, wider to float64
    x = np.array(x, dtype=np.promote_types(x.dtype, np.float32))
    vmin, vmax = np.float64(vmin), np.float64(vmax)
    if vmin == vmax:
        x.fill(0)
    else:
        x -= vmin
        x /= vmax - vmin
    n = table.shape[0]
    x *= n
    x[x == n] = n - 1
    under, over, bad = x < 0, x >= n, np.isnan(x)
    with np.errstate(invalid="ignore"):
        idx = x.astype(int)
    idx[under], idx[over] = 0, n - 1
    idx[bad] = 0
    rgba = np.empty(x.shape + (4,), np.uint8)
    rgba[..., :3] = table[idx]
    rgba[..., 3] = 255
    rgba[bad] = 0
    return rgba


def _prepare_series(resistances, meta, value: str, mode: str, use_log: bool):
    if value == "state":
        params = meta.get("params") or {}
        ron = float(params.get("r_on", params.get("Ron", 1.0)))
        roff = float(params.get("r_off", params.get("Roff", 2.0)))
        base = resistance_to_state(resistances, ron, roff)
        label = "State w (0-1)"
        sign = 1.0
    else:
        base = resistances
        label = "Resistance (Ohm)"
        sign = -1.0  # resistance falls as the device is driven
    b0 = base[0]
    eps = 1e-9
    if mode == "abs":
        data = base
    elif mode == "delta":
        data = sign * (base - b0)
        label = f"delta {label}"
    elif mode == "rel":
        data = sign * (base - b0) / (np.abs(b0) + eps)
        label = f"relative change of {label}"
    else:
        raise ValueError(f"unknown mode {mode!r}")
    if use_log:
        data = np.log10(np.maximum(data, eps))
        label = f"log10({label})"
    return data, label


def visualize_npz(
    npz_path: str | pathlib.Path,
    mode: str = "abs",
    value: str = "resistance",
    use_log: bool = False,
    fps: Optional[float] = None,
    key_every: int = 0,
    key_dir: Optional[pathlib.Path] = None,
    save_colorbar: bool = True,
    save_mp4: bool = False,
) -> dict:
    """Render all requested artifacts; returns a dict of output paths."""
    npz_path = pathlib.Path(npz_path)
    data = np.load(npz_path)
    if "w_final" not in data or "resistances" not in data:
        raise KeyError(f"{npz_path} missing 'w_final'/'resistances'")
    w_final = data["w_final"]
    resistances = data["resistances"]
    meta = load_metadata(npz_path)
    if fps is None:
        fps = float(meta.get("fps", 30.0))

    out: dict[str, str] = {}

    # final-state image: viridis over its own range (imshow's autoscale)
    w_path = npz_path.with_suffix(".w_final.png")
    w2 = np.atleast_2d(w_final)
    w_path.write_bytes(encode_png(colormap_rgba(
        w2, VIRIDIS_RGB, float(np.nanmin(w2)), float(np.nanmax(w2)))))
    out["w_final"] = str(w_path)

    if resistances.ndim != 3 or resistances.shape[0] == 0:
        return out

    series, label = _prepare_series(resistances, meta, value, mode, use_log)
    vmin = float(np.nanmin(series))
    vmax = float(np.nanmax(series))
    if vmax - vmin < 1e-12:
        vmax = vmin + 1e-12

    if key_every and key_every > 0:
        kdir = pathlib.Path(key_dir or npz_path.parent / f"{npz_path.stem}_keyframes")
        kdir.mkdir(parents=True, exist_ok=True)
        manifest = {
            "source_npz": str(npz_path),
            "key_every": int(key_every),
            "vmin": vmin,
            "vmax": vmax,
            "fps": float(fps),
            "label": label,
            "frames": [],
        }
        for idx in range(0, series.shape[0], key_every):
            fpath = kdir / f"frame_{idx:05d}.png"
            fpath.write_bytes(encode_png(colormap_rgba(series[idx], INFERNO_RGB, vmin, vmax)))
            manifest["frames"].append(
                {"index": int(idx), "time_s": float(idx / fps), "path": fpath.name})
        with open(kdir / "manifest.json", "w") as fp:
            json.dump(manifest, fp, indent=2)
        out["keyframes"] = str(kdir)

    if save_colorbar:
        cb_path = npz_path.with_suffix(".colorbar.png")
        grad = np.tile(np.linspace(0, 1, 600, dtype=np.float32), (60, 1))
        cb_path.write_bytes(encode_png(colormap_rgba(grad, INFERNO_RGB, 0.0, 1.0)))
        out["colorbar"] = str(cb_path)

    if save_mp4:
        cv2 = require_cv2("the MP4 animation")
        vid_path = npz_path.with_suffix(f".{value}_{mode}.mp4")
        h, w = series.shape[1:]
        vw = cv2.VideoWriter(str(vid_path), cv2.VideoWriter_fourcc(*"mp4v"),
                             min(fps, 60.0), (w, h), isColor=True)
        for frame in series:
            vw.write(_render_frame_u8(frame, vmin, vmax))
        vw.release()
        out["mp4"] = str(vid_path)

    return out


def write_video(frames, out_path, fps: float) -> None:
    """Grayscale MP4 preview writer (eventsim write_video, :86-97): each
    frame is min-max normalised independently.  Needs OpenCV: raises
    ``RuntimeError`` naming it where it is not installed."""
    frames = list(frames)
    cv2 = require_cv2("the eventsim video")
    if not frames:
        return
    h, w = np.asarray(frames[0]).shape
    vw = cv2.VideoWriter(str(out_path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h),
                         isColor=False)
    for f in frames:
        vw.write(cv2.normalize(np.asarray(f), None, 0, 255, cv2.NORM_MINMAX).astype(np.uint8))
    vw.release()
