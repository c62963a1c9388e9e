"""Device ms a pair of FlowFormer's update: every device operation whose launch
lies inside the program's ``nsof.flowformer.update`` spans (``benchmark/spans.py``):
GMA's aggregation, the motion encoder, the SepConvGRU, the flow and mask heads and
the coordinates, one a step."""

from benchmark import spans


def read(r):
    return spans.device_ms_per_pair(r, "nsof.flowformer.update")
