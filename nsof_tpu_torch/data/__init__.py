"""Host-side data layer of the port: the bundled reference scenes, the flow
datasets, OpenCV's image arithmetic in numpy, and the ground-truth mask
tooling (the OWL-ViT → SAM chain and its weightless stand-ins)."""
