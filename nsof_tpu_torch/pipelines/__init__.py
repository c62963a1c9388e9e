"""Pipelines of the port: segmentation (the main path and the dual path),
tracking and prediction."""
