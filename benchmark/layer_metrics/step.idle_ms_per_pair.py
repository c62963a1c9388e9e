"""Device idle ms a pair inside the step: the stretches, from the traced
window's first device operation on, in which the device runs nothing
while the main thread is inside a step span (``nsof.seg_batch_fast`` or
``nsof.stream_masks``; ``benchmark/spans.py``).  The lead-in after the
window's opening synchronisation and the harness's work between calls
are left out."""

from benchmark import spans


def read(r):
    s = spans.of(r)
    return None if s is None else s.step_idle_seconds() * 1e3 / r.traced_pairs
