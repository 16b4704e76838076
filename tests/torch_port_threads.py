"""One torch thread for the port's CPU tests.

The suite runs in several worker processes at once (pytest-xdist), each
with torch's default of one intra-op thread per core, and the workers'
thread pools then compete for the same cores: a file that takes 14 s alone
took over 300 s in a six-worker run. A test module that imports
`one_torch_thread` runs its tests on one torch thread and puts the count
back afterwards; the shapes here are small, so a thread pool buys little.
A module whose parity depends on the default pool's summation order (the
full-depth ResNet-50 forward of tests/test_torch_port_resnet.py) does not
import it, nor does tests/test_torch_port_cuda.py, which runs on the card
only."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
