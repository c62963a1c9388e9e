"""Device ms a frame of SAM's decoding: every device operation whose launch lies
inside the program's ``nsof.sam.decode`` spans (``benchmark/spans.py``):
the prompt encoder, the gather of each box's frame embedding, the
two-way transformer, the upscaling, the hypernetwork and IoU heads."""

from benchmark import spans


def read(r):
    return spans.device_ms_per_pair(r, "nsof.sam.decode")
