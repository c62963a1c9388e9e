"""The whole step's share of the chip's peak: the step's least time a
pair (``benchmark.roofline.step_counts``) over its measured time a pair,
the inverse of the same run's ``pairs_per_s``."""

from benchmark import roofline


def read(r):
    rate = r.host.get("pairs_per_s")
    if not rate:
        return None
    ops, nbytes = roofline.step_counts(r.cell.config, r.cell.traffic, r.cell.params)
    return 100.0 * roofline.least_seconds(ops, nbytes) * rate
