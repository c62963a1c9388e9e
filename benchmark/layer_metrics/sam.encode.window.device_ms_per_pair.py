"""Device ms a frame of SAM's windowed blocks: every device operation whose launch lies
inside the program's ``nsof.sam.encode.window`` spans (``benchmark/spans.py``):
the 28 windowed blocks of vit_h, each its LayerNorms, the zero padding and
window folds, qkv, the attention with its relative-position einsums, the
projection and the MLP."""

from benchmark import spans


def read(r):
    return spans.device_ms_per_pair(r, "nsof.sam.encode.window")
