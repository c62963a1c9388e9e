"""K4's share of its roofline: the least time of the traced pairs' K4 work
(``benchmark.roofline.k4_counts``) over the device time of the kernels
named ``fused_box_update_kernel`` in the traced window."""

from benchmark import roofline


def read(r):
    if r.trace is None or not r.traced_pairs:
        return None
    seconds, launches = r.trace.kernel_seconds("fused_box_update_kernel")
    if not launches:
        return None
    ops, nbytes = roofline.k4_counts(r.cell.config)
    return 100.0 * roofline.least_seconds(ops, nbytes) * r.traced_pairs / seconds
