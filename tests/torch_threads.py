"""One intra-op torch thread for each port test module.

The suite runs its files in parallel worker processes; torch's default of
a thread a core then oversubscribes the CPU, and the port's many small CPU
ops stall in their thread pool (a module's time grew 10-30x under load).
A module that imports :func:`one_torch_thread` runs on one thread and
restores the count after.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
