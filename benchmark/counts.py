"""The program's work counters and what the ``flow.*`` readers take from
them.

While a profiler records, the port's ``nsof_tpu_torch/utils/timing.py::
count`` appends one entry a call under ``nsof.gate``, at the end of the
gate (``rows``, the batch; ``active`` ``[B]``; ``box`` ``[B, 4]`` as
``(x0, y0, x1, y1)``; the window origins ``oys``, ``oxs`` ``[B]``; the
window shape ``win``, ``(wh, ww)``), and one under ``nsof.flow``, where the
flow layer starts (``rows`` it computed, ``px`` it computed a row: the
Farnebäck window, or the deep backend's /8-padded window).  In a run only
the traced window records, so both hold the traced calls; their device
tensors are reduced here, after the window's closing synchronisation.  A
program without the counters, or a run without a trace, reads None.
"""

from __future__ import annotations

import dataclasses

# the flow layer's spans: the Farnebäck cells', the deep cells'
FLOW_SPANS = ("nsof.farneback", "nsof.deep.flow")


@dataclasses.dataclass
class Work:
    """The gate's and the flow layer's work over the recorded calls."""

    gated: int  # rows the gate saw
    active: int  # of those, the rows it kept
    kept_px: int  # pixels of the kept rows' boxes inside their windows
    rows: int  # rows the flow layer computed
    px: int  # pixels the flow layer computed


def kept_px(entry: dict) -> int:
    """Pixels of the active rows' boxes inside their windows, from the box
    and window coordinates: the sum of ``window_box_mask(box, oys, oxs,
    wh, ww) & active`` without the mask."""
    import torch

    box = entry["box"].to(torch.int64)
    oy, ox = entry["oys"].to(torch.int64), entry["oxs"].to(torch.int64)
    wh, ww = entry["win"]
    hi = (torch.minimum(box[:, 3], oy + wh) - torch.maximum(box[:, 1], oy)).clamp(min=0)
    wi = (torch.minimum(box[:, 2], ox + ww) - torch.maximum(box[:, 0], ox)).clamp(min=0)
    return int((hi * wi * entry["active"].to(torch.int64)).sum())


def work(reading) -> Work | None:
    """The recorded calls' :class:`Work`; None without a trace, a pair, the
    program's counters or a record."""
    if reading.trace is None or not reading.traced_pairs:
        return None
    try:
        from nsof_tpu_torch.utils import timing
    except ImportError:
        return None
    counted = getattr(timing, "counted", None)
    gate, flow = (counted("nsof.gate"), counted("nsof.flow")) if counted else ((), ())
    if not gate or not flow:
        return None
    w = Work(gated=sum(e["rows"] for e in gate),
             active=sum(int(e["active"].sum()) for e in gate),
             kept_px=sum(kept_px(e) for e in gate),
             rows=sum(e["rows"] for e in flow),
             px=sum(e["rows"] * e["px"] for e in flow))
    return w if w.rows and w.px else None
