"""Device ms a frame of SAM's preprocessing: every device operation whose launch lies
inside the program's ``nsof.sam.preprocess`` spans (``benchmark/spans.py``):
the longest side's uint8 resize, the normalisation, the zero padding to the
square."""

from benchmark import spans


def read(r):
    return spans.device_ms_per_pair(r, "nsof.sam.preprocess")
