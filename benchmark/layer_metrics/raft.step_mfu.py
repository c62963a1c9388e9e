"""The deep ROI step's share of the chip's peak: a pair's least time from
the configuration's shapes (``benchmark.roofline.raft``: the convolutions
at the TF32 dense peak, the correlation at the float32 peak) over its
measured time a pair, the inverse of the same run's ``pairs_per_s``."""

from benchmark.roofline import raft


def read(r):
    rate = r.host.get("pairs_per_s")
    if not rate or "model" not in r.cell.config:
        return None
    return 100.0 * raft.least_seconds(r.cell.config) * rate
