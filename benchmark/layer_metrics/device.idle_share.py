"""The device's idle share of the traced window: 1 − the union of its
operations' intervals over the window's length."""


def read(r):
    if r.trace is None or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
