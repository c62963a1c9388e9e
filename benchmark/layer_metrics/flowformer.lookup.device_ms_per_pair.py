"""Device ms a pair of FlowFormer's lookup: every device operation whose launch
lies inside the program's ``nsof.flowformer.lookup`` spans (``benchmark/spans.py``):
the 9x9 cost windows, one a decoder step."""

from benchmark import spans


def read(r):
    return spans.device_ms_per_pair(r, "nsof.flowformer.lookup")
