"""K5's share of its roofline: the least time of the traced pairs' K5 work
(``benchmark.roofline.k5_counts``) over the device time of the kernels
named ``update_matrices_sep_kernel`` in the traced window (the level
route launches K3's kernel only as K5)."""

from benchmark import roofline


def read(r):
    if r.trace is None or not r.traced_pairs:
        return None
    seconds, launches = r.trace.kernel_seconds("update_matrices_sep_kernel")
    if not launches:
        return None
    ops, nbytes = roofline.k5_counts(r.cell.config)
    return 100.0 * roofline.least_seconds(ops, nbytes) * r.traced_pairs / seconds
