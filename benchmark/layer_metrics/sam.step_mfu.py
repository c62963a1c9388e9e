"""SAM's ground-truth step's share of the chip's peak: a frame's least time
from the configuration's shapes and the traffic's boxes a frame
(``benchmark.roofline.sam``: the convolutions at the TF32 dense peak, the
matrix products at the float32 peak) over its measured time a frame, the
inverse of the same run's ``pairs_per_s``."""

from benchmark.roofline import sam


def read(r):
    rate = r.host.get("pairs_per_s")
    if not rate or r.cell.config.get("model", {}).get("arch") != "sam":
        return None
    return 100.0 * sam.least_seconds(r.cell.config, r.cell.params) * rate
