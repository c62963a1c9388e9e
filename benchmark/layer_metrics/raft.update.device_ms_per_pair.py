"""Device ms a pair of RAFT's update: every device operation whose launch
lies inside the program's ``nsof.raft.update`` spans (``benchmark/spans.py``):
the refinements' update block (the motion encoder, the SepConvGRU, the flow and mask heads) and coordinate updates."""

from benchmark import spans


def read(r):
    return spans.device_ms_per_pair(r, "nsof.raft.update")
