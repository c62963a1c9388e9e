"""Pipelines of the port: segmentation (the main path and the dual path),
tracking, prediction, the stream, the FLAG=1 regions, the scene runners, the
deep backends' pipelines and detection on the ROI (``run_detection``)."""
