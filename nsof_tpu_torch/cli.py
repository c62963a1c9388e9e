"""Command-line interface of the port: the counterpart of :mod:`nsof_tpu.cli`.

Subcommands, with the JAX CLI's flags and defaults plus ``--device``
(default the CUDA device; ``--device cpu`` runs the plain PyTorch versions):

- ``seg`` / ``track`` / ``predict`` — run a task pipeline on a bundled
  scene (the reference's optical_flow_{seg,ob,prediction}.py mains).
- ``deep`` — the deep-backend pipelines (RAFT or FlowFormer, 1/3 frames,
  MEMSIZE/3 gating) on a scene; ``--torch-ckpt`` loads a reference
  checkpoint, ``--ckpt`` (a training checkpoint) waits for the training
  slice and raises.
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
written as ``.png``.  Scene loading (``load_scene``) reads a scene of PNG
frames with the port's codec and the reference's JPEG scenes through
OpenCV.

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


def _deep_backend(args):
    """The ``deep`` subcommand's backend: RAFT (``--small`` / ``--basic``,
    ``--iters``) or FlowFormer (things_eval), with a reference checkpoint's
    weights (``--torch-ckpt``) or, without one, random weights from torch's
    generator seeded with 0."""
    import torch

    from nsof_tpu_torch.pipelines.deep_flow import DeepBackend

    if args.ckpt:
        raise NotImplementedError(
            "--ckpt reads a training checkpoint (an orbax TrainState); the port's training "
            "slice (train/*, data/flow_datasets.py, the train and validate subcommands) is "
            "not ported yet: pass a reference .pth with --torch-ckpt")
    torch.manual_seed(0)
    if args.backend == "raft":
        from nsof_tpu_torch.models.raft import RAFT, RaftConfig

        if args.torch_ckpt:
            from nsof_tpu_torch.models.convert import pretrained_raft

            model = pretrained_raft(args.torch_ckpt, iters=args.iters)
        else:
            model = RAFT(RaftConfig(small=args.small, iters=args.iters))
        return DeepBackend.from_raft(model, iters=args.iters, device=args.device)
    from nsof_tpu_torch.models.flowformer import FlowFormer, FlowFormerConfig

    if args.torch_ckpt:
        from nsof_tpu_torch.models.flowformer.convert import pretrained_flowformer

        model = pretrained_flowformer(args.torch_ckpt)
    else:
        model = FlowFormer(FlowFormerConfig())
    return DeepBackend.from_flowformer(model, device=args.device)


def cmd_deep(args) -> int:
    """The deep-backend pipelines (raft_{seg,ob,prediction}.py and the ff_*
    equivalents): frames resized to 1/3, MEMSIZE/3 gating, RAFT or
    FlowFormer flow, the task head; one JSON record a frame pair in
    ``deep_<task>.json``."""
    import dataclasses

    import numpy as np
    import torch

    from nsof_tpu_torch.data.scenes import load_scene
    from nsof_tpu_torch.pipelines import deep_flow as dfl

    backend = _deep_backend(args)
    scene = load_scene(args.data_root, args.scene, args.max_frames)
    cfg0 = scene.cfg
    h3, w3 = cfg0.image_h // 3, cfg0.image_w // 3
    cfg = dataclasses.replace(cfg0, image_h=h3, image_w=w3, window_h=h3, window_w=w3)
    step = {
        "seg": lambda m, p, n, f: dfl.deep_roi_flow_step(m, p, n, cfg, backend),
        "track": lambda m, p, n, f: dfl.deep_roi_tracking_step(m, p, n, cfg, backend),
        "predict": lambda m, p, n, f: dfl.deep_roi_prediction_step(m, p, n, f, cfg, backend),
    }[args.task]
    out_dir = pathlib.Path(args.out or f"output/{args.scene}_deep_{args.task}")
    out_dir.mkdir(parents=True, exist_ok=True)
    frames3 = torch.stack([dfl.resize_third(torch.from_numpy(f).to(backend.device))
                           for f in scene.frames_bgr]).to(torch.uint8)
    rows = []
    for i in range(scene.num_pairs):
        mem2, _, _ = scene.pair_inputs(i)
        out = step(mem2, frames3[i], frames3[i + 1], frames3[i + 1])
        rec = {"frame": scene.names[i + 1], "active": bool(out["any_active"]),
               "region_pct": float(out["region_pct"])}
        if args.task == "track":
            rec["boxes"] = out["boxes"][out["valid"]].cpu().numpy().tolist()
        rows.append(rec)
    (out_dir / f"deep_{args.task}.json").write_text(json.dumps(rows, indent=1))
    print(json.dumps({"pairs": len(rows), "out": str(out_dir)}))
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

    p = sub.add_parser("deep")
    _add_scene_args(p)
    p.add_argument("--task", choices=["seg", "track", "predict"], default="seg")
    p.add_argument("--backend", choices=["raft", "flowformer"], default="raft")
    p.add_argument("--ckpt", default=None,
                   help="training checkpoint (waits for the port's training slice)")
    p.add_argument("--torch-ckpt", default=None,
                   help="reference torch checkpoint (raft-things.pth, raft-small.pth, "
                        "FlowFormer things.pth)")
    p.add_argument("--small", action="store_true", default=True)
    p.add_argument("--basic", dest="small", action="store_false")
    p.add_argument("--iters", type=int, default=20)
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
    if args.cmd == "deep":
        return cmd_deep(args)
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
