"""Device ms a pair of FlowFormer's encode: every device operation whose launch
lies inside the program's ``nsof.flowformer.encode`` spans (``benchmark/spans.py``):
the input scaling, the context Twins on the first frame, the feature Twins on both
frames and the channel convertor, the decoder's context projection and tanh/relu split, GMA's
attention map."""

from benchmark import spans


def read(r):
    return spans.device_ms_per_pair(r, "nsof.flowformer.encode")
