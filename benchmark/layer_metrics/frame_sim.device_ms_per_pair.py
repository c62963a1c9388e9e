"""Device ms a pair of the device simulation: every device operation
launched from inside ``device/frame_sim.py`` of the port (the compression
and K8), by the Python frames around each launch."""

MODULES = ("nsof_tpu_torch/device/frame_sim.py",)


def read(r):
    if r.trace is None or not r.traced_pairs:
        return None
    seconds = r.trace.module_seconds(MODULES)
    return None if seconds is None else seconds * 1e3 / r.traced_pairs
