"""The FlowFormer ROI step's share of the chip's peak: a pair's least time
from the configuration's shapes (``benchmark.roofline.flowformer``: the
convolutions at the TF32 dense peak, the matrix products at the float32
peak) over its measured time a pair, the inverse of the same run's
``pairs_per_s``."""

from benchmark.roofline import flowformer


def read(r):
    rate = r.host.get("pairs_per_s")
    if not rate or r.cell.config.get("model", {}).get("arch") != "flowformer":
        return None
    return 100.0 * flowformer.least_seconds(r.cell.config) * rate
