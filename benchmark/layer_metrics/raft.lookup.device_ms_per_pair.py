"""Device ms a pair of RAFT's lookup: every device operation whose launch
lies inside the program's ``nsof.raft.lookup`` spans (``benchmark/spans.py``):
the windowed pyramid lookups, one a refinement."""

from benchmark import spans


def read(r):
    return spans.device_ms_per_pair(r, "nsof.raft.lookup")
