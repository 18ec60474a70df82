"""One PyTorch thread per test process for the port's CPU tests.

The tier-1 run puts six pytest workers on the host's cores, and PyTorch's
default of one intra-op thread per core in each of them oversubscribes the
host several times over: on an 8-core host the port's test files took 282 s
on 6 workers with the default and 59 s with one thread each. Every
``tests/test_torch_port_*.py`` module imports ``one_torch_thread``, which
sets one thread for the module and puts the count back after it."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
