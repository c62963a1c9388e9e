"""Share of the pixels the flow layer computed that the gate keeps, %: the
pixels of the active rows' boxes inside their windows, from the box and
window coordinates, over the pixels the flow computed (the deep path's
/8-padded windows), in the traced calls (``benchmark/counts.py``)."""

from benchmark import counts


def read(r):
    w = counts.work(r)
    return None if w is None else 100.0 * w.kept_px / w.px
