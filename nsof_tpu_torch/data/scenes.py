"""Loaders for the reference's bundled scene datasets: the port's
counterpart of :mod:`nsof_tpu.data.scenes`.

Each scene directory (``data/{grasp,tabletennis,autodriving,uav,uavnew2}``)
holds ``RGB/``, ``gtmask/``, ``imgs.txt``, ``Parameters.txt`` and
``constructed_3D_matrix.mat`` with key ``constructed3DMatrix``
(optical_flow_seg.py:398-399).  Loading is host-side (the data layer); the
runners move a scene's arrays to the device.  A :class:`SceneData` built
from arrays needs nothing beyond numpy.
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import Optional

import numpy as np

from nsof_tpu_torch.config import DATASETS, PipelineConfig


@dataclasses.dataclass
class SceneData:
    """In-memory scene: frames + state matrices, reference index semantics.

    ``mem_gray[t]`` is the uint8 conductance→gray transform of state slice
    ``offset + t`` — pair ``t`` uses ``mem_gray[t + 1]`` as its gating map
    (memimg2, optical_flow_seg.py:417/219).
    """

    cfg: PipelineConfig
    frames_bgr: np.ndarray  # [T, H, W, 3] uint8 (cv2 BGR order)
    frames_gray: np.ndarray  # [T, H, W] uint8 (reference's RGB2GRAY-on-BGR)
    mem_gray: np.ndarray  # [Tm, gh, gw] uint8
    gt_masks: Optional[np.ndarray]  # [T, H, W] uint8 {0,255} or None
    names: list[str]

    def pair_inputs(self, i: int):
        """(mem2, prev_gray, next_gray) for pair i — reference loop
        semantics (optical_flow_seg.py:413-437)."""
        return (
            self.mem_gray[i + 1],
            self.frames_gray[i],
            self.frames_gray[i + 1],
        )

    @property
    def num_pairs(self) -> int:
        return min(len(self.names) - 2, self.mem_gray.shape[0] - 1)


def load_scene(
    root: str | pathlib.Path,
    name: str,
    max_frames: Optional[int] = None,
) -> SceneData:
    """Load one bundled scene from a reference-layout data root.

    The reference's frames are JPEG, which the port's own codec
    (:mod:`nsof_tpu_torch.utils.png`) does not read, so this function, and
    only it, imports OpenCV (``cv2``), here inside the call: where OpenCV is
    not installed it raises ``ImportError``, and a scene is built with
    :class:`SceneData` from arrays instead.
    """
    import cv2
    import scipy.io

    from nsof_tpu_torch.device.model import conductance_to_gray

    cfg = DATASETS[name]
    d = pathlib.Path(root) / name
    imgs = (d / "imgs.txt").read_text().splitlines()
    imgs = [s for s in imgs if s.strip()]
    if max_frames:
        imgs = imgs[:max_frames]

    # JPEG decode dominates load time on the big scenes (grasp: 101 frames
    # @1080x1920); cv2.imread releases the GIL, so decode frames concurrently.
    from concurrent.futures import ThreadPoolExecutor

    def _load_one(fn):
        bgr = cv2.imread(str(d / "RGB" / fn))
        # the reference calls COLOR_RGB2GRAY on the BGR-loaded frame
        # (optical_flow_seg.py:442) — reproduce exactly
        gray = cv2.cvtColor(bgr, cv2.COLOR_RGB2GRAY)
        gt = None
        gt_path = d / "gtmask" / fn
        if gt_path.exists():
            g = cv2.cvtColor(cv2.imread(str(gt_path)), cv2.COLOR_BGR2GRAY)
            _, g = cv2.threshold(g, 127, 256, cv2.THRESH_BINARY)
            gt = g
        return bgr, gray, gt

    with ThreadPoolExecutor(max_workers=16) as pool:
        loaded = list(pool.map(_load_one, imgs))
    frames = [f for f, _, _ in loaded]
    grays = [g for _, g, _ in loaded]
    gts = [m for _, _, m in loaded if m is not None]

    mat = scipy.io.loadmat(str(d / "constructed_3D_matrix.mat"))
    mem = mat["constructed3DMatrix"]  # [gh, gw, Tm]
    tm = mem.shape[2] if max_frames is None else min(mem.shape[2], len(imgs))
    slices = np.moveaxis(mem[:, :, cfg.offset:tm], -1, 0)
    mem_gray = conductance_to_gray(np.ascontiguousarray(slices)).numpy()
    return SceneData(
        cfg=cfg,
        frames_bgr=np.stack(frames),
        frames_gray=np.stack(grays),
        mem_gray=mem_gray,
        gt_masks=np.stack(gts) if len(gts) == len(imgs) else None,
        names=imgs,
    )
