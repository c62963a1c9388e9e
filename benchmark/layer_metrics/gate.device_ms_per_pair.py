"""Device ms a pair of the ROI gate (``roi_boxes``, ``window_origin``,
``region_percentage``): every device operation whose launch lies inside
the program's ``nsof.gate`` span (``benchmark/spans.py``)."""

from benchmark import spans


def read(r):
    return spans.device_ms_per_pair(r, "nsof.gate")
