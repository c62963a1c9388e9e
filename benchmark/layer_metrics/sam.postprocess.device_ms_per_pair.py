"""Device ms a frame of SAM's postprocessing: every device operation whose launch lies
inside the program's ``nsof.sam.postprocess`` spans (``benchmark/spans.py``):
the two linear resizes of every box's logits, the threshold and each
frame's OR of its masks."""

from benchmark import spans


def read(r):
    return spans.device_ms_per_pair(r, "nsof.sam.postprocess")
