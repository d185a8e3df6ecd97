"""One PyTorch intra-op thread for the port's CPU tests.

Their tensors are small, and the suite runs in several worker processes
beside XLA's own thread pools: with one thread per core in every worker
the plain versions ran up to 30x slower than with one.  A test module
imports ``one_torch_thread``; being autouse and module-scoped, it holds
the setting for that module and restores it after."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
