"""Optical-flow dataset IO, augmentation and loaders (host data layer): the
port of :mod:`nsof_tpu.data.flow_datasets`.

Covers the reference's training data stack (codebase/RAFT/core/datasets.py,
core/utils/frame_utils.py, core/utils/augmentor.py): .flo / .pfm / KITTI
16-bit png flow IO, photometric + spatial augmentation (dense and sparse
variants), directory scanners for the standard benchmarks, and batch
iterators feeding the train step.  A synthetic affine-warp dataset provides
ground-truthed samples for tests and smoke training without the
(multi-hundred-GB) public benchmarks.

numpy on the host, without OpenCV (it is not installed beside the port's
GPU runtime): images are read by the port's PNG and PPM codecs
(:func:`read_image`; JPEG raises), and the OpenCV calls of the JAX module
are :mod:`nsof_tpu_torch.data.imgproc`'s.  Every function draws from its
``rng`` exactly what the JAX function draws, in the same order, so one seed
gives the same scales, crops, flips and eraser boxes in both packages.
"""

from __future__ import annotations

import dataclasses
import pathlib
import re
from typing import Iterator, Optional

import numpy as np

from nsof_tpu_torch.data import imgproc
from nsof_tpu_torch.utils.png import decode_png, decode_png16, encode_png16
from nsof_tpu_torch.utils.ppm import decode_ppm

TAG_FLOAT = 202021.25  # .flo magic


# ── image and flow file IO ────────────────────────────────────────────────


def read_image(path) -> np.ndarray:
    """uint8 ``[H, W, 3]`` RGB frame from a .png or .ppm file (what
    ``cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)`` gives); another
    format raises ``ValueError``."""
    p = pathlib.Path(path)
    data = p.read_bytes()
    if p.suffix.lower() == ".ppm":
        return decode_ppm(data)
    return decode_png(data)


def read_flo(path) -> np.ndarray:
    """Middlebury .flo reader."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, 1)[0]
        assert magic == TAG_FLOAT, f"bad .flo magic {magic}"
        w = int(np.fromfile(f, np.int32, 1)[0])
        h = int(np.fromfile(f, np.int32, 1)[0])
        data = np.fromfile(f, np.float32, 2 * h * w)
    return data.reshape(h, w, 2)


def write_flo(path, flow: np.ndarray) -> None:
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.asarray([TAG_FLOAT], np.float32).tofile(f)
        np.asarray([w, h], np.int32).tofile(f)
        flow.astype(np.float32).tofile(f)


def read_pfm(path) -> np.ndarray:
    """PFM reader (FlyingThings3D flow storage)."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        color = header == b"PF"
        dims = re.match(rb"^(\d+)\s(\d+)\s$", f.readline())
        w, h = map(int, dims.groups())
        scale = float(f.readline().rstrip())
        data = np.fromfile(f, "<f" if scale < 0 else ">f")
    shape = (h, w, 3) if color else (h, w)
    return np.flipud(data.reshape(shape))


def read_kitti_flow(path) -> tuple[np.ndarray, np.ndarray]:
    """KITTI 16-bit png: flow = (png[:, :, :2] - 2^15) / 64, valid =
    png[:, :, 2] (channels in RGB order)."""
    png = decode_png16(pathlib.Path(path).read_bytes()).astype(np.float64)
    flow = (png[:, :, :2] - 2**15) / 64.0
    valid = png[:, :, 2].astype(bool)
    return flow.astype(np.float32), valid


def write_kitti_flow(path, flow: np.ndarray,
                     valid: Optional[np.ndarray] = None) -> None:
    h, w = flow.shape[:2]
    v = (np.ones((h, w)) if valid is None else valid).astype(np.uint16)
    enc = np.clip(flow * 64.0 + 2**15, 0, 2**16 - 1).astype(np.uint16)
    png = np.stack([enc[..., 0], enc[..., 1], v], axis=-1)  # RGB
    pathlib.Path(path).write_bytes(encode_png16(png))


def read_flow_any(path) -> tuple[np.ndarray, Optional[np.ndarray]]:
    """Dispatch on extension (frame_utils.read_gen)."""
    p = pathlib.Path(path)
    if p.suffix == ".flo":
        return read_flo(p), None
    if p.suffix == ".pfm":
        return read_pfm(p)[..., :2].astype(np.float32), None
    if p.suffix == ".png":
        return read_kitti_flow(p)
    raise ValueError(f"unknown flow format: {p}")


# ── augmentation ─────────────────────────────────────────────────────────


@dataclasses.dataclass
class AugmentorConfig:
    """Photometric + spatial augmentation (core/utils/augmentor.py)."""

    crop_size: tuple[int, int] = (368, 496)
    min_scale: float = -0.2
    max_scale: float = 0.5
    do_flip: bool = True
    spatial_aug_prob: float = 0.8
    h_flip_prob: float = 0.5
    v_flip_prob: float = 0.1
    brightness: float = 0.4
    contrast: float = 0.4
    saturation: float = 0.4
    hue: float = 0.16
    asymmetric_color_prob: float = 0.2
    eraser_prob: float = 0.5
    sparse: bool = False  # KITTI-style valid-mask-aware resampling


def _photometric(rng: np.random.Generator, img: np.ndarray,
                 cfg: AugmentorConfig) -> np.ndarray:
    out = img.astype(np.float32)
    out = out * rng.uniform(1 - cfg.contrast, 1 + cfg.contrast)
    out = out + 255.0 * rng.uniform(-cfg.brightness, cfg.brightness) * 0.5
    hsv = imgproc.rgb_to_hsv_u8(np.clip(out, 0, 255).astype(np.uint8)).astype(np.float32)
    hsv[..., 1] *= rng.uniform(1 - cfg.saturation, 1 + cfg.saturation)
    hsv[..., 0] = (hsv[..., 0] + rng.uniform(-cfg.hue, cfg.hue) * 180) % 180
    out = imgproc.hsv_to_rgb_u8(np.clip(hsv, 0, 255).astype(np.uint8))
    return out.astype(np.uint8)


def augment_pair(
    rng: np.random.Generator,
    img1: np.ndarray,
    img2: np.ndarray,
    flow: np.ndarray,
    cfg: AugmentorConfig,
    valid: Optional[np.ndarray] = None,
):
    """Spatial (scale/crop/flip) + photometric + eraser augmentation.

    Returns (img1, img2, flow, valid) at crop_size.
    """
    ch, cw = cfg.crop_size
    h, w = img1.shape[:2]

    # photometric (asymmetric with small probability, augmentor.py)
    if rng.random() < cfg.asymmetric_color_prob:
        img1 = _photometric(rng, img1, cfg)
        img2 = _photometric(rng, img2, cfg)
    else:
        stacked = np.concatenate([img1, img2], axis=0)
        stacked = _photometric(rng, stacked, cfg)
        img1, img2 = stacked[:h], stacked[h:]

    # spatial: random scale
    min_scale = max((ch + 8) / h, (cw + 8) / w)
    scale = 2.0 ** rng.uniform(cfg.min_scale, cfg.max_scale)
    scale = max(scale, min_scale)
    if rng.random() < cfg.spatial_aug_prob or scale > 1.0:
        nh, nw = round(h * scale), round(w * scale)
        img1 = imgproc.resize_linear(img1, nw, nh)
        img2 = imgproc.resize_linear(img2, nw, nh)
        if cfg.sparse and valid is not None:
            flow, valid = _sparse_resize(flow, valid, scale)
        else:
            flow = imgproc.resize_linear(np.asarray(flow, np.float32), nw, nh) * scale
            valid = None if valid is None else (
                imgproc.resize_linear(valid.astype(np.uint8), nw, nh) > 0
            )
        h, w = nh, nw

    # flips
    if cfg.do_flip and rng.random() < cfg.h_flip_prob:
        img1 = img1[:, ::-1]
        img2 = img2[:, ::-1]
        flow = flow[:, ::-1] * [-1.0, 1.0]
        valid = None if valid is None else valid[:, ::-1]
    if cfg.do_flip and rng.random() < cfg.v_flip_prob:
        img1 = img1[::-1]
        img2 = img2[::-1]
        flow = flow[::-1] * [1.0, -1.0]
        valid = None if valid is None else valid[::-1]

    # crop
    y0 = rng.integers(0, max(h - ch, 0) + 1)
    x0 = rng.integers(0, max(w - cw, 0) + 1)
    img1 = img1[y0 : y0 + ch, x0 : x0 + cw]
    img2 = img2[y0 : y0 + ch, x0 : x0 + cw]
    flow = flow[y0 : y0 + ch, x0 : x0 + cw]
    valid = None if valid is None else valid[y0 : y0 + ch, x0 : x0 + cw]

    # eraser on img2 (occlusion augmentation, augmentor.py eraser_transform)
    if rng.random() < cfg.eraser_prob:
        mean = img2.reshape(-1, 3).mean(axis=0)
        for _ in range(rng.integers(1, 3)):
            ex = rng.integers(0, cw)
            ey = rng.integers(0, ch)
            dx = rng.integers(50, 100)
            dy = rng.integers(50, 100)
            img2 = img2.copy()
            img2[ey : ey + dy, ex : ex + dx] = mean

    if valid is None:
        valid = (np.abs(flow[..., 0]) < 1000) & (np.abs(flow[..., 1]) < 1000)
    return (
        np.ascontiguousarray(img1),
        np.ascontiguousarray(img2),
        np.ascontiguousarray(flow.astype(np.float32)),
        np.ascontiguousarray(valid),
    )


def _sparse_resize(flow, valid, scale):
    """Sparse-flow rescaling by point reprojection (augmentor.py
    SparseFlowAugmentor.resize_sparse_flow_map)."""
    h, w = flow.shape[:2]
    nh, nw = round(h * scale), round(w * scale)
    ys, xs = np.nonzero(valid)
    fx = flow[ys, xs, 0] * scale
    fy = flow[ys, xs, 1] * scale
    nxs = np.round(xs * scale).astype(int)
    nys = np.round(ys * scale).astype(int)
    keep = (nxs >= 0) & (nxs < nw) & (nys >= 0) & (nys < nh)
    out = np.zeros((nh, nw, 2), np.float32)
    vout = np.zeros((nh, nw), bool)
    out[nys[keep], nxs[keep], 0] = fx[keep]
    out[nys[keep], nxs[keep], 1] = fy[keep]
    vout[nys[keep], nxs[keep]] = True
    return out, vout


# ── datasets ─────────────────────────────────────────────────────────────


@dataclasses.dataclass
class FlowPair:
    img1_path: str
    img2_path: str
    flow_path: Optional[str]


def scan_sintel(root, split="training", dstype="clean") -> list[FlowPair]:
    """MPI-Sintel layout (datasets.py MpiSintel)."""
    root = pathlib.Path(root)
    pairs = []
    img_root = root / split / dstype
    for scene in sorted(p for p in img_root.iterdir() if p.is_dir()):
        frames = sorted(scene.glob("*.png"))
        for i in range(len(frames) - 1):
            flow = (
                root / split / "flow" / scene.name / f"frame_{i+1:04d}.flo"
            )
            pairs.append(
                FlowPair(str(frames[i]), str(frames[i + 1]),
                         str(flow) if flow.exists() else None)
            )
    return pairs


def scan_flying_chairs(root, split="training") -> list[FlowPair]:
    root = pathlib.Path(root) / "data"
    pairs = []
    for flo in sorted(root.glob("*_flow.flo")):
        stem = flo.name[: -len("_flow.flo")]
        pairs.append(
            FlowPair(
                str(root / f"{stem}_img1.ppm"),
                str(root / f"{stem}_img2.ppm"),
                str(flo),
            )
        )
    return pairs


def scan_flying_things(root, dstype="frames_cleanpass") -> list[FlowPair]:
    """FlyingThings3D layout (datasets.py FlyingThings3D): left camera,
    both temporal directions — into_past pairs are reversed images with
    the i+1 backward flow."""
    root = pathlib.Path(root)
    pairs = []
    for direction in ("into_future", "into_past"):
        image_dirs = sorted(root.glob(f"{dstype}/TRAIN/*/*"))
        flow_dirs = sorted(root.glob("optical_flow/TRAIN/*/*"))
        for idir, fdir in zip(image_dirs, flow_dirs):
            images = sorted((idir / "left").glob("*.png"))
            flows = sorted((fdir / direction / "left").glob("*.pfm"))
            for i in range(len(flows) - 1):
                if direction == "into_future":
                    pairs.append(FlowPair(str(images[i]), str(images[i + 1]),
                                          str(flows[i])))
                else:
                    pairs.append(FlowPair(str(images[i + 1]), str(images[i]),
                                          str(flows[i + 1])))
    return pairs


def scan_hd1k(root) -> list[FlowPair]:
    """HD1K layout (datasets.py HD1K): per-sequence png frames with
    sparse flow_occ ground truth."""
    root = pathlib.Path(root)
    pairs = []
    seq = 0
    while True:
        flows = sorted(root.glob(f"hd1k_flow_gt/flow_occ/{seq:06d}_*.png"))
        images = sorted(root.glob(f"hd1k_input/image_2/{seq:06d}_*.png"))
        if not flows:
            break
        for i in range(len(flows) - 1):
            pairs.append(FlowPair(str(images[i]), str(images[i + 1]),
                                  str(flows[i])))
        seq += 1
    return pairs


def scan_kitti(root, split="training") -> list[FlowPair]:
    root = pathlib.Path(root) / split
    pairs = []
    for i2 in sorted((root / "image_2").glob("*_10.png")):
        stem = i2.name.split("_")[0]
        pairs.append(
            FlowPair(
                str(i2),
                str(root / "image_2" / f"{stem}_11.png"),
                str(root / "flow_occ" / f"{stem}_10.png")
                if (root / "flow_occ" / f"{stem}_10.png").exists()
                else None,
            )
        )
    return pairs


def synthetic_affine_dataset(
    rng: np.random.Generator,
    n: int = 16,
    size: tuple[int, int] = (96, 128),
    max_shift: float = 6.0,
) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Ground-truthed samples without benchmark downloads: textured noise
    images warped by random translations (exact GT flow)."""
    h, w = size
    out = []
    for _ in range(n):
        base = imgproc.gaussian_blur(
            (rng.random((h + 32, w + 32, 3)) * 255).astype(np.float32), 2.0
        )
        dx, dy = rng.uniform(-max_shift, max_shift, 2)
        img1 = base[16 : 16 + h, 16 : 16 + w].astype(np.uint8)
        # the JAX function hands OpenCV the float32 matrix [[1, 0, -dx], [0, 1, -dy]]
        warped = imgproc.warp_translate(base, float(np.float32(dx)), float(np.float32(dy)))
        img2 = warped[16 : 16 + h, 16 : 16 + w].astype(np.uint8)
        flow = np.full((h, w, 2), [-dx, -dy], np.float32)
        out.append((img1, img2, flow))
    return out


def load_item(item):
    """(img1, img2, flow, valid) of a :class:`FlowPair` (read from disk) or
    an in-memory (img1, img2, flow) triple (valid None)."""
    if isinstance(item, FlowPair):
        fl, valid = read_flow_any(item.flow_path)
        return read_image(item.img1_path), read_image(item.img2_path), fl, valid
    i1, i2, fl = item
    return i1, i2, fl, None


def stack_batch(samples) -> dict:
    """The train step's batch from (img1, img2, flow, valid) samples."""
    b1, b2, bf, bv = zip(*samples)
    return {
        "image1": np.stack(b1).astype(np.float32),
        "image2": np.stack(b2).astype(np.float32),
        "flow": np.stack(bf),
        "valid": np.stack(bv).astype(np.float32),
    }


def batch_iterator(
    pairs,
    batch_size: int,
    rng: np.random.Generator,
    aug: Optional[AugmentorConfig] = None,
    epochs: Optional[int] = None,
) -> Iterator[dict]:
    """Yield train-step batches from (img1, img2, flow) triples or
    FlowPair paths, with optional augmentation."""
    epoch = 0
    while epochs is None or epoch < epochs:
        order = rng.permutation(len(pairs))
        for s in range(0, len(order) - batch_size + 1, batch_size):
            samples = []
            for idx in order[s : s + batch_size]:
                i1, i2, fl, valid = load_item(pairs[idx])
                if aug is not None:
                    i1, i2, fl, valid = augment_pair(rng, i1, i2, fl, aug,
                                                     valid)
                elif valid is None:
                    valid = np.ones(fl.shape[:2], bool)
                samples.append((i1, i2, fl, valid))
            yield stack_batch(samples)
        epoch += 1
