"""The synthetic scene the runner parity files (``test_torch_runner_*.py``)
share: the tabletennis preset cut to 96×128 with a 64×96 window and
memsize 16 (a 6×8 state grid), 6 frames of a bright 24×24 box moving
(2, 3) px a frame over a random texture, the state map active on the cells
under the box, and the box as the GT mask; made with numpy from a seed.
One scene object per package, on the same arrays."""

import csv
import dataclasses

import numpy as np

from nsof_tpu.config import DATASETS
from nsof_tpu.data.scenes import SceneData as JScene
from nsof_tpu_torch.config import config_from_dict
from nsof_tpu_torch.data.scenes import SceneData as TScene

H, W, MEMSIZE, T = 96, 128, 16, 6
BOX = 24
# the CSV columns that hold no time: equal as written, and the metrics held
# to a tolerance, within one unit of their last printed (4th) decimal
EXACT_COLUMNS = ("Frame_Pair", "Original_IoU", "Mem_IoU", "Region_Percent")
METRIC_COLUMNS = ("Original_PA", "Mem_PA", "Original_SSIM", "Mem_SSIM")


def cfgs():
    cfg = dataclasses.replace(DATASETS["tabletennis"], name="runner96", image_h=H, image_w=W,
                              window_h=64, window_w=96)
    cfg = dataclasses.replace(cfg, roi=dataclasses.replace(cfg.roi, memsize=MEMSIZE))
    return cfg, config_from_dict(dataclasses.asdict(cfg))


def arrays(seed: int = 0):
    rng = np.random.default_rng(seed)
    texture = (rng.random((H, W, 3)) * 120).astype(np.uint8)
    bgr = np.broadcast_to(texture, (T, H, W, 3)).copy()
    gt = np.zeros((T, H, W), np.uint8)
    mem = np.zeros((T, H // MEMSIZE, W // MEMSIZE), np.uint8)
    for t in range(T):
        y, x = 30 + 2 * t, 40 + 3 * t
        bgr[t, y : y + BOX, x : x + BOX] = (230, 200, 170)
        gt[t, y : y + BOX, x : x + BOX] = 255
        mem[t, y // MEMSIZE : (y + BOX - 1) // MEMSIZE + 1,
            x // MEMSIZE : (x + BOX - 1) // MEMSIZE + 1] = 255
    # the reference's COLOR_RGB2GRAY on the BGR frame
    b, g, r = (bgr[..., i].astype(np.int64) for i in range(3))
    gray = ((b * 9798 + g * 19235 + r * 3735 + (1 << 14)) >> 15).astype(np.uint8)
    return bgr, gray, mem, gt, [f"{t:04d}.jpg" for t in range(T)]


def scenes():
    jcfg, tcfg = cfgs()
    bgr, gray, mem, gt, names = arrays()
    return (JScene(jcfg, bgr, gray, mem, gt, names),
            TScene(tcfg, bgr, gray, mem, gt, names))


def read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], [dict(zip(rows[0], r)) for r in rows[1:]]


def assert_csv_values_equal(got_path, ref_path):
    """Headers equal; row by row, every column that holds no time equal,
    the PA and SSIM columns within one unit of their 4th decimal (values
    within the metrics' tolerances can round to neighbouring strings)."""
    got_head, got = read_csv(got_path)
    ref_head, ref = read_csv(ref_path)
    assert got_head == ref_head
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        for col in EXACT_COLUMNS:
            if col in r:
                assert g[col] == r[col], (col, g[col], r[col])
        for col in METRIC_COLUMNS:
            if col in r:
                assert (g[col] == "") == (r[col] == ""), col
                if r[col]:
                    assert abs(float(g[col]) - float(r[col])) <= 1.5e-4, (col, g[col], r[col])


def assert_timing_keys(got: dict, ref: dict):
    assert set(got) == set(ref)
    assert set(got["stage_totals_s"]) == set(ref["stage_totals_s"])
    assert got["dispatch_floor_s"] >= 0
