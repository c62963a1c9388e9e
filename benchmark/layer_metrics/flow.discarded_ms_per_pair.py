"""Device ms a pair the flow layer spends on pairs whose flow the gate then
discards: the device time of the ``nsof.farneback`` or ``nsof.deep.flow``
spans a traced pair (``benchmark/spans.py``) times the inactive rows' share
of the rows the flow computed (``benchmark/counts.py``).  This assumes every
row of a batch costs the same, which holds for both flow paths: each runs
its fixed-shape batch through kernels and layers that do the same work for
every row, whatever the gate decided."""

from benchmark import counts, spans


def read(r):
    w = counts.work(r)
    ms = [spans.device_ms_per_pair(r, name) for name in counts.FLOW_SPANS]
    if w is None or ms[0] is None:
        return None
    return sum(ms) * (w.gated - w.active) / w.rows
