"""Device ms a pair of FlowFormer's query: every device operation whose launch
lies inside the program's ``nsof.flowformer.query`` spans (``benchmark/spans.py``):
the flow-token encoder and its cross attention into the cost memory, one a step."""

from benchmark import spans


def read(r):
    return spans.device_ms_per_pair(r, "nsof.flowformer.query")
