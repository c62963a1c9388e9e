"""Device ms a frame of SAM's global blocks: every device operation whose launch lies
inside the program's ``nsof.sam.encode.global`` spans (``benchmark/spans.py``):
the 4 global blocks of vit_h (7, 15, 23, 31), each its LayerNorms, qkv, the
attention over all 4,096 tokens with its relative-position einsums, the
projection and the MLP."""

from benchmark import spans


def read(r):
    return spans.device_ms_per_pair(r, "nsof.sam.encode.global")
