"""Operators of the port: ROI gate, fast Farnebäck (K1–K4), morphology."""
