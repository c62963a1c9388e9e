"""CSV/txt reporting with the reference's column schemas: the port's copy
of :mod:`nsof_tpu.utils.reporting`.

Every reference pipeline writes a per-frame CSV (schemas at
optical_flow_seg.py:366-382, optical_flow_ob.py:460-476,
optical_flow_prediction.py:410-427) plus a free-text log.  The columns are
kept byte-compatible so downstream analyses of reference outputs keep
working.
"""

from __future__ import annotations

import csv
import pathlib
from typing import Iterable

SEG_COLUMNS = [
    "Frame_Pair",
    "Original_Flow_Time",
    "Mem_Flow_Time",
    "Flow_Time_Improvement",
    "Flow_Time_Improvement_Percent",
    "Original_Seg_Time",
    "Mem_Seg_Time",
    "Combination_Time",
    "Original_PA",
    "Mem_PA",
    "Region_Percent",
    "Cal_Times",
    "Velocity_Times",
]

OB_COLUMNS = [
    "Frame_Pair",
    "Original_Flow_Time",
    "Mem_Flow_Time",
    "Flow_Time_Improvement",
    "Flow_Time_Improvement_Percent",
    "Original_OB_Time",
    "Mem_OB_Time",
    "Combination_Time",
    "Original_IoU",
    "Mem_IoU",
    "Region_Percent",
    "Cal_Times",
    "Velocity_Times",
]

PRED_COLUMNS = [
    "Frame_Pair",
    "Original_Flow_Time",
    "Mem_Flow_Time",
    "Flow_Time_Improvement",
    "Flow_Time_Improvement_Percent",
    "Original_Pred_Time",
    "Mem_Pred_Time",
    "Combination_Time",
    "Original_SSIM",
    "Mem_SSIM",
    "Region_Percent",
    "Cal_Times",
    "Velocity_Times",
]


class CsvReport:
    def __init__(self, path: str | pathlib.Path, columns: Iterable[str]):
        self.path = pathlib.Path(path)
        self.columns = list(columns)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with open(self.path, "w", newline="") as f:
            csv.writer(f).writerow(self.columns)

    def add(self, row: dict):
        with open(self.path, "a", newline="") as f:
            csv.writer(f).writerow([row.get(c, "") for c in self.columns])


class TextLog:
    def __init__(self, path: str | pathlib.Path):
        self.path = pathlib.Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.path.write_text("")

    def write(self, line: str):
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(line + "\n")
