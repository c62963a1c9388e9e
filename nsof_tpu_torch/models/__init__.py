"""The models of the port: the deep flow models RAFT (:mod:`.raft`, weights
from reference checkpoints through :mod:`.convert`) and FlowFormer
(:mod:`.flowformer`), the detector YOLOv8 (:mod:`.yolov8`), and the
ground-truth tooling's SAM (:mod:`.sam`) and OWL-ViT (:mod:`.owlvit`)."""
