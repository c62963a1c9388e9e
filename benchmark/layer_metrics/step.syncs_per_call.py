"""Host synchronisations a call: the CUDA runtime calls that wait for the
device (``benchmark.spans.SYNC_CALLS``) made on the main thread inside a
step span, read from the run's Chrome trace, over the traced calls."""

from benchmark import spans


def read(r):
    s = spans.of(r)
    if s is None or not s.steps:
        return None
    return spans.syncs(spans.trace_path(r), s) / len(s.steps)
