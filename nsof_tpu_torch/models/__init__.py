"""The deep flow models of the port: RAFT (:mod:`.raft`, weights from
reference checkpoints through :mod:`.convert`) and FlowFormer
(:mod:`.flowformer`)."""
