"""Operators of the port: ROI gate, labelling and NMS, the exact and fast
Farnebäck (K1–K7), morphology, colour space, warp, SSIM, and JAX's resize
weights (:mod:`.resize`)."""
