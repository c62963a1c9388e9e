"""Pipelines of the port: the ROI-gated segmentation path."""
