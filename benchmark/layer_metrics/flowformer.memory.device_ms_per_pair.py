"""Device ms a pair of FlowFormer's memory: every device operation whose launch
lies inside the program's ``nsof.flowformer.memory`` spans (``benchmark/spans.py``):
the cost volume, each cost map's patch embedding, the latent tokens' cross attention,
the self and vertical layers, the decoder's k/v projection of the memory."""

from benchmark import spans


def read(r):
    return spans.device_ms_per_pair(r, "nsof.flowformer.memory")
