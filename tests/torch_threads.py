"""One intra-op thread for the port's CPU tests.

The port's tests run many small PyTorch ops.  PyTorch's default intra-op
pool has a thread per core, and tier-1 runs six pytest workers at once,
so each worker's pool spins against the others' for cores and every file
slows several times over.  A test module imports this fixture (autouse)
to run its tests on one intra-op thread; the process's setting comes back
after each test, so other modules on the same worker keep theirs."""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
