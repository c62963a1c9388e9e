"""Device ms a pair of the fast Farnebäck: every device operation launched
from inside ``ops/farneback_fast.py`` of the port (its pyramid glue and
the kernels it launches), by the Python frames around each launch."""

MODULES = ("nsof_tpu_torch/ops/farneback_fast.py",)


def read(r):
    if r.trace is None or not r.traced_pairs:
        return None
    seconds = r.trace.module_seconds(MODULES)
    return None if seconds is None else seconds * 1e3 / r.traced_pairs
