"""One intra-op thread for the port's CPU tests.

The tier-1 lane runs test files side by side in several worker processes.
PyTorch's CPU ops default to one OpenMP thread a core in each process, and
those threads spin while they wait: six workers of eight threads each on
eight cores slow the tiny shapes of these tests by an order of magnitude
(six copies of ``test_torch_speculative.py`` side by side took 327 s with
the default and 42 s with one thread each, on an 8-core host).  A test
module that imports ``one_torch_thread`` runs its tests with one thread
and restores the count after them.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
