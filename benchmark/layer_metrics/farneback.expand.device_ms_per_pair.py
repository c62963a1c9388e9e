"""Device ms a pair of the Farnebäck's polynomial expansion: every device
operation whose launch lies inside the program's ``nsof.farneback.expand``
spans (``benchmark/spans.py``): K2 on the fused route, the plain-torch
``poly_expansion_fast`` and r1's edge padding on the level route."""

from benchmark import spans


def read(r):
    return spans.device_ms_per_pair(r, "nsof.farneback.expand")
