"""The models of the port: the deep flow models RAFT (:mod:`.raft`, weights
from reference checkpoints through :mod:`.convert`) and FlowFormer
(:mod:`.flowformer`), and the detector YOLOv8 (:mod:`.yolov8`)."""
