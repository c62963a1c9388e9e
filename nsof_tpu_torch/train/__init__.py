"""Training infrastructure for the deep backends (the port of
:mod:`nsof_tpu.train`)."""

from nsof_tpu_torch.train.loss import sequence_loss  # noqa: F401
from nsof_tpu_torch.train.optim import raft_optimizer  # noqa: F401
