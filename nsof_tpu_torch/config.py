"""Typed pipeline configuration: the port's copy of :mod:`nsof_tpu.config`.

:func:`config_from_dict` builds a :class:`PipelineConfig` from
``dataclasses.asdict`` of the JAX package's, so both packages can run on one
configuration, ``dataclasses.replace`` overrides included.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from nsof_tpu_torch.ops.farneback import PRESETS as FB_PRESETS, FarnebackParams
from nsof_tpu_torch.ops.roi import RoiConfig


@dataclasses.dataclass(frozen=True)
class HeadConfig:
    """Task-head parameters shared by seg/tracking/prediction."""

    seg_th: float = 1.0  # SEG_TH (optical_flow_seg.py:49)
    morph_ksize: int = 10  # elliptical SE size for the seg head (:349)
    morph_iters: int = 5  # dilate+erode repetitions (:350)
    close_ksize: int = 3  # tracking head MORPH_CLOSE SE (optical_flow_ob.py:344)
    min_box_area: int = 500  # tracking contour-area filter (:351)
    nms_iou: float = 0.2  # tracking NMS threshold (:373)
    max_boxes: int = 32  # static slots for tracking boxes


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """One dataset's full pipeline configuration."""

    name: str
    image_h: int
    image_w: int
    roi: RoiConfig = RoiConfig()
    fb: FarnebackParams = FarnebackParams()
    head: HeadConfig = HeadConfig()
    # static ROI-window size; None ⇒ full image
    window_h: Optional[int] = None
    window_w: Optional[int] = None
    # FLAG=1 separate-regions mode: per-component window and MERGE_FLAG
    sep_window_h: Optional[int] = None
    sep_window_w: Optional[int] = None
    merge_flag: bool = True
    offset: int = 0  # OFFSET into the state matrix (optical_flow_seg.py:37)
    # audited per-level warp radius of the fast Farnebäck path
    warp_radius: int = 3

    @property
    def win_shape(self) -> tuple[int, int]:
        return (self.window_h or self.image_h, self.window_w or self.image_w)

    @property
    def sep_win_shape(self) -> tuple[int, int]:
        return (
            self.sep_window_h or self.win_shape[0],
            self.sep_window_w or self.win_shape[1],
        )


def _roi(memsize, thres, mode=2, k_max=16):
    return RoiConfig(memsize=memsize, thres=thres, mode=mode, k_max=k_max)


DATASETS = {
    "grasp": PipelineConfig(
        name="grasp", image_h=1920, image_w=1080, roi=_roi(80, 250),
        fb=FB_PRESETS["grasp"], window_h=None, window_w=None,
    ),
    "tabletennis": PipelineConfig(
        name="tabletennis", image_h=160, image_w=160, roi=_roi(10, 245),
        fb=FB_PRESETS["tabletennis"], window_h=160, window_w=160,
        warp_radius=5,
    ),
    "autodriving": PipelineConfig(
        name="autodriving", image_h=801, image_w=801,
        roi=_roi(200, 114, mode=1), fb=FB_PRESETS["autodriving"],
        window_h=801, window_w=801, warp_radius=3,
    ),
    "uav": PipelineConfig(
        name="uav", image_h=161, image_w=161, roi=_roi(40, 114, mode=1),
        fb=FB_PRESETS["uav"], window_h=161, window_w=161, warp_radius=3,
    ),
    "uavnew2": PipelineConfig(
        name="uavnew2", image_h=600, image_w=600, roi=_roi(40, 114, mode=1),
        fb=FB_PRESETS["uavnew2"], window_h=600, window_w=600, warp_radius=3,
    ),
}

# FLAG=1 preset for grasp: per-component 320×320 windows, per-region head
DATASETS["grasp_sep"] = dataclasses.replace(
    DATASETS["grasp"],
    name="grasp_sep",
    roi=_roi(80, 250, mode=1, k_max=8),
    sep_window_h=320,
    sep_window_w=320,
    merge_flag=False,
)


def config_from_dict(d: dict) -> PipelineConfig:
    """A :class:`PipelineConfig` from a dict of its fields, with ``roi``,
    ``fb`` and ``head`` as nested dicts (``dataclasses.asdict`` of either
    package's config)."""
    d = dict(d)
    d["roi"] = RoiConfig(**d["roi"])
    d["fb"] = FarnebackParams(**d["fb"])
    d["head"] = HeadConfig(**d["head"])
    return PipelineConfig(**d)
