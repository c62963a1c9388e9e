"""Utilities of the port: the PNG codec, flow visualisation, timing and the
reference's CSV reporting."""
