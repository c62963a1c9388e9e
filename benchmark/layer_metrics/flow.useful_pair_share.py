"""Share of the pairs the flow layer computed whose flow the gate keeps, %:
the gate's active rows over the rows the flow computed, in the traced calls
(``benchmark/counts.py``)."""

from benchmark import counts


def read(r):
    w = counts.work(r)
    return None if w is None else 100.0 * w.active / w.rows
