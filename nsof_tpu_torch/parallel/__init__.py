"""Training on the port's device: :mod:`.train` holds the RAFT and
FlowFormer train steps on one device (the JAX package's mesh-sharded
``parallel/`` maps onto ``torch.distributed`` in a later slice)."""
