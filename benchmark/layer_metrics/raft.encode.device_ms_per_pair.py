"""Device ms a pair of RAFT's encode: every device operation whose launch
lies inside the program's ``nsof.raft.encode`` spans (``benchmark/spans.py``):
the input scaling, the feature encoder on both frames, the context encoder and its tanh/relu split."""

from benchmark import spans


def read(r):
    return spans.device_ms_per_pair(r, "nsof.raft.encode")
