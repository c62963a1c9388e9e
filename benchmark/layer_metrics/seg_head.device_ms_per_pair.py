"""Device ms a pair of the seg head: every device operation launched from
inside ``ops/morphology_fast.py`` or the head's ``_seg_head_mag2`` of the
port, by the Python frames around each launch."""

MODULES = ("nsof_tpu_torch/ops/morphology_fast.py", ": _seg_head_mag2")


def read(r):
    if r.trace is None or not r.traced_pairs:
        return None
    seconds = r.trace.module_seconds(MODULES)
    return None if seconds is None else seconds * 1e3 / r.traced_pairs
