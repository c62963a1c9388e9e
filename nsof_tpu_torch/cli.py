"""Command-line interface of the port: the counterpart of :mod:`nsof_tpu.cli`.

Subcommands, with the JAX CLI's flags and defaults plus ``--device``
(default the CUDA device; ``--device cpu`` runs the plain PyTorch versions):

- ``seg`` / ``track`` / ``predict`` — run a task pipeline on a bundled
  scene (the reference's optical_flow_{seg,ob,prediction}.py mains).
- ``eventsim`` — event-driven device simulation from HDF5 or the synthetic
  moving-box stream (eventsim/event_mem_sim.py CLI, :334-373); only with
  ``--no-video`` (the video writer is not ported).
- ``framesim`` — frame-driven simulation from a folder of frames (the
  reference's MATLAB simulation of the device over a frame sequence).
- ``flow`` — Farnebäck flow over a folder of frames, as Middlebury images.
- ``stream`` — frames folder → device-state scan → ROI-gated masks.
- ``serve`` — the demo HTTP server.

Frames are read and written as PNG (:mod:`nsof_tpu_torch.utils.png`); a
JPEG input raises, and an output the JAX CLI names after a ``.jpg`` input is
written as ``.png``.  Scene loading (``load_scene``) reads the reference's
JPEG scenes through OpenCV.

Run ``python -m nsof_tpu_torch.cli <command> --help`` for options.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys


def _add_scene_args(p):
    p.add_argument("--data-root", required=True,
                   help="the reference's data root, holding one folder a scene")
    p.add_argument("--scene", default="tabletennis",
                   help="grasp|tabletennis|autodriving|uav|uavnew2")
    p.add_argument("--out", default=None, help="output directory")
    p.add_argument("--max-frames", type=int, default=None)


def _frame_files(folder: pathlib.Path) -> list[pathlib.Path]:
    """The PNG frames of ``folder``, numeric stems in numeric order; raises
    ``ValueError`` when it holds JPEG frames, which the port cannot read."""
    jpegs = sorted([*folder.glob("*.jpg"), *folder.glob("*.jpeg")])
    if jpegs:
        raise ValueError(f"{folder} holds JPEG frames ({jpegs[0].name}, ...); the port reads "
                         "PNG only: convert the frames to PNG")
    return sorted(folder.glob("*.png"),
                  key=lambda f: int(f.stem) if f.stem.isdigit() else f.stem)


def _read_gray(path: pathlib.Path):
    from nsof_tpu_torch.utils.png import decode_png

    return decode_png(path.read_bytes(), gray=True)


def _write_png(path: pathlib.Path, img) -> None:
    from nsof_tpu_torch.utils.png import encode_png

    path.write_bytes(encode_png(img))


def _png_name(name: str) -> str:
    return str(pathlib.PurePath(name).with_suffix(".png"))


def cmd_task(kind: str, args) -> int:
    import numpy as np

    from nsof_tpu_torch.data.scenes import load_scene
    from nsof_tpu_torch.pipelines import runner

    scene = load_scene(args.data_root, args.scene, args.max_frames)
    out_dir = pathlib.Path(args.out or f"output/{args.scene}_{kind}")
    out_dir.mkdir(parents=True, exist_ok=True)
    if kind == "seg":
        res = runner.run_segmentation(
            scene, csv_path=out_dir / "metrics_seg.csv", device=args.device
        )
        for i in range(res.masks.shape[0]):
            name = _png_name(scene.names[i + 1])
            _write_png(out_dir / f"seg_{name}", res.masks[i])
            _write_png(out_dir / f"origseg_{name}", res.masks_full[i])
    elif kind == "track":
        res = runner.run_tracking(scene, device=args.device)
        rows = []
        for i in range(res.boxes.shape[0]):
            keep = res.boxes[i][res.boxes_valid[i]]
            rows.append({"frame": scene.names[i + 1],
                         "boxes": keep.tolist()})
        (out_dir / "tracks.json").write_text(json.dumps(rows, indent=2))
    else:
        res = runner.run_prediction(scene, device=args.device)
        for i in range(res.preds.shape[0]):
            # the predicted frames are BGR, as the scene's; PNG holds RGB
            _write_png(out_dir / f"pred_{_png_name(scene.names[i + 1])}",
                       np.ascontiguousarray(res.preds[i][..., ::-1]))
    print(json.dumps({"metrics": res.metrics, "timing": res.timing}))
    return 0


def cmd_eventsim(args) -> int:
    from nsof_tpu_torch.device import (
        EventSimConfig,
        bin_events,
        generate_synthetic_events,
        io,
        simulate_events,
    )

    if not args.no_video:
        raise NotImplementedError(
            "the eventsim video writer (utils/visualize.py) is not ported; pass --no-video")
    h5_path = pathlib.Path(args.h5)
    if args.synthetic:
        x, y, p, t = generate_synthetic_events()
        h5_path = pathlib.Path("synthetic.hdf5")
        io.save_events_h5(h5_path, x, y, p, t)
        print(f"synthetic stream saved to {h5_path}")
    else:
        x, y, p, t, _, _ = io.load_events_h5(h5_path)

    binned = bin_events(x, y, p, t, slice_us=args.slice_us)
    cfg = EventSimConfig(
        version=args.version,
        active_v=args.active_v,
        silent_v=args.silent_v,
        polarity=args.polarity,
    )
    out = simulate_events(binned, cfg, device=args.device)
    npz = h5_path.with_suffix(f".V{args.version}.npz")
    io.save_sim_npz(npz, out["w_final"].cpu(), out["resistances"].cpu())
    io.save_sim_metadata(
        h5_path.with_suffix(f".V{args.version}.json.gz"),
        cfg, args.slice_us, h5_path,
    )
    if args.version == 2:
        io.save_sim_npz(
            h5_path.with_suffix(".V2_b.npz"),
            out["w_final_b"].cpu(), out["resistances_b"].cpu(),
        )
    print(f"results -> {npz}")
    return 0


def cmd_framesim(args) -> int:
    import numpy as np

    from nsof_tpu_torch.device import FrameSimConfig, compress_frames, simulate_frames

    folder = pathlib.Path(args.frames)
    files = _frame_files(folder)[args.start : args.end : args.interval]
    frames = np.stack([_read_gray(f) for f in files]).astype(np.float32) / 255.0
    region = None
    if args.region:
        y0, x0, y1, x1 = map(int, args.region.split(","))
        region = ((y0, x0), (y1, x1))
    grid = compress_frames(
        frames, args.m, args.n,
        region_ul=region[0] if region else None,
        region_lr=region[1] if region else None,
        device=args.device,
    )
    cfg = FrameSimConfig(m=args.m, n=args.n, th1=args.th1, th2=args.th2,
                         n_substeps=args.substeps)
    out = simulate_frames(grid, cfg, device=args.device)
    np_out = pathlib.Path(args.out or folder.parent / "framesim_result.npz")
    np.savez_compressed(
        np_out,
        w_final=out["w_final"].cpu().numpy(),
        resistances=out["resistances"].cpu().numpy(),
    )
    print(f"results -> {np_out}")
    return 0


def cmd_flow(args) -> int:
    """Folder flow inference + Middlebury color images (the RAFT demo.py
    equivalent, with the Farnebäck backend)."""
    from nsof_tpu_torch.ops.farneback import PRESETS, FarnebackParams, farneback
    from nsof_tpu_torch.utils.flow_viz import flow_to_image

    folder = pathlib.Path(args.frames)
    files = _frame_files(folder)
    out_dir = pathlib.Path(args.out or folder.parent / "flow_viz")
    out_dir.mkdir(parents=True, exist_ok=True)
    params = PRESETS.get(args.preset, FarnebackParams())
    n = 0
    for f1, f2 in zip(files[:-1], files[1:]):
        flow = farneback(_read_gray(f1), _read_gray(f2), params, device=args.device)
        _write_png(out_dir / f"flow_{f1.stem}.png", flow_to_image(flow).cpu().numpy())
        n += 1
    print(f"{n} flow visualisations -> {out_dir}")
    return 0


def cmd_stream(args) -> int:
    """Streaming end-to-end: frames folder → device-state scan → batched
    ROI-gated seg masks, in chunks (pipelines/stream.py)."""
    import dataclasses

    import numpy as np

    from nsof_tpu_torch.config import DATASETS
    from nsof_tpu_torch.device.frame_sim import FrameSimConfig
    from nsof_tpu_torch.pipelines.stream import stream_masks_chunked

    folder = pathlib.Path(args.frames)
    files = _frame_files(folder)
    frames = np.stack([_read_gray(f) for f in files])
    cfg = DATASETS[args.preset]
    if frames.shape[1:] != (cfg.image_h, cfg.image_w):
        cfg = dataclasses.replace(
            cfg, image_h=frames.shape[1], image_w=frames.shape[2],
            window_h=None, window_w=None,
        )
    if args.thres is not None:
        cfg = dataclasses.replace(
            cfg, roi=dataclasses.replace(cfg.roi, thres=args.thres)
        )
    sim = FrameSimConfig(
        m=cfg.roi.memsize, n=cfg.roi.memsize, n_substeps=args.substeps
    )
    out = stream_masks_chunked(
        frames, cfg, sim, chunk_pairs=args.chunk_pairs,
        kernel_mode=args.kernel_mode, device=args.device
    )
    out_dir = pathlib.Path(args.out or folder.parent / "stream_masks")
    out_dir.mkdir(parents=True, exist_ok=True)
    masks = out["masks"].cpu().numpy()
    for i in range(masks.shape[0]):
        _write_png(out_dir / f"mask_{files[i+1].stem}.png", masks[i])
    act = int(out["any_active"].sum())
    print(
        f"{masks.shape[0]} masks -> {out_dir} "
        f"(active pairs: {act}, mean region "
        f"{float(out['region_pct'].mean()):.1f}%)"
    )
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nsof_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    device_help = "torch device (default: the CUDA device; 'cpu' runs the plain versions)"

    parsers = []
    for kind in ("seg", "track", "predict"):
        p = sub.add_parser(kind)
        _add_scene_args(p)
        parsers.append(p)

    p = sub.add_parser("eventsim")
    p.add_argument("--h5", default="driving_data.hdf5")
    p.add_argument("--version", type=int, choices=[1, 2], default=1)
    p.add_argument("--slice_us", type=int, default=1000)
    p.add_argument("--active_v", type=float, default=-6.0)
    p.add_argument("--silent_v", type=float, default=0.0)
    p.add_argument("--polarity", choices=["split", "magnitude"],
                   default="split")
    p.add_argument("--no-video", action="store_true")
    p.add_argument("--synthetic", action="store_true")
    parsers.append(p)

    p = sub.add_parser("framesim")
    p.add_argument("--frames", required=True, help="folder of PNG frames")
    p.add_argument("--m", type=int, default=40)
    p.add_argument("--n", type=int, default=40)
    p.add_argument("--th1", type=float, default=0.7)
    p.add_argument("--th2", type=float, default=1.5)
    p.add_argument("--substeps", type=int, default=1000)
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--end", type=int, default=None)
    p.add_argument("--interval", type=int, default=1)
    p.add_argument("--region", default=None, help="y0,x0,y1,x1 inclusive")
    p.add_argument("--out", default=None)
    parsers.append(p)

    p = sub.add_parser("flow")
    p.add_argument("--frames", required=True, help="folder of PNG frames")
    p.add_argument("--preset", default="grasp",
                   help="farneback preset: grasp|tabletennis|autodriving|uav")
    p.add_argument("--out", default=None)
    parsers.append(p)

    p = sub.add_parser("stream")
    p.add_argument("--frames", required=True, help="folder of PNG frames")
    p.add_argument("--preset", default="tabletennis",
                   help="dataset preset for ROI/flow params")
    p.add_argument("--thres", type=int, default=None,
                   help="override the activity threshold (the preset's "
                        "THRES was tuned for the reference .mat state)")
    p.add_argument("--chunk-pairs", type=int, default=64)
    p.add_argument("--substeps", type=int, default=1000)
    p.add_argument("--kernel-mode", default="auto",
                   help="fast Farnebäck route: auto|fused|fused_f32|pallas_sep|pallas|xla")
    p.add_argument("--out", default=None)
    parsers.append(p)

    p = sub.add_parser("serve")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7860)
    parsers.append(p)

    for p in parsers:
        p.add_argument("--device", default=None, help=device_help)

    args = ap.parse_args(argv)
    if args.cmd in ("seg", "track", "predict"):
        return cmd_task(args.cmd, args)
    if args.cmd == "eventsim":
        return cmd_eventsim(args)
    if args.cmd == "framesim":
        return cmd_framesim(args)
    if args.cmd == "flow":
        return cmd_flow(args)
    if args.cmd == "stream":
        return cmd_stream(args)
    from nsof_tpu_torch.serve.app import serve

    serve(args.host, args.port, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
