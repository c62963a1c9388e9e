"""Device ms a pair of the scatter: the mask's, and the flow's negation,
masking and scatter into the frame; every device operation whose launch
lies inside the program's ``nsof.scatter`` span (``benchmark/spans.py``)."""

from benchmark import spans


def read(r):
    return spans.device_ms_per_pair(r, "nsof.scatter")
