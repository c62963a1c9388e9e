"""Kernels launched a pair: the kernels in the traced window over the
pairs it computed."""


def read(r):
    if r.trace is None or not r.traced_pairs:
        return None
    return len(r.trace.kernels) / r.traced_pairs
