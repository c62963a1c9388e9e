"""Device ms a pair of RAFT's corr: every device operation whose launch
lies inside the program's ``nsof.raft.corr`` spans (``benchmark/spans.py``):
the all-pairs correlation's matrix product and its pooled pyramid."""

from benchmark import spans


def read(r):
    return spans.device_ms_per_pair(r, "nsof.raft.corr")
