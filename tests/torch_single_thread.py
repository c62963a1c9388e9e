"""A fixture for the port's CPU test files whose PyTorch side runs many
small operations (eager loops, a serving thread, batch-1 stages): one
intra-op thread while the file runs, restored after it.  The suite runs
six worker processes on one shared CPU, where every parallel region of a
small operation waits until each of PyTorch's threads is scheduled; the
event simulator's 54,000 operations took 561 s that way and 2 s alone."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
