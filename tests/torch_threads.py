"""A fixture for the CPU test files whose runs are many small torch ops:
one intra-op thread for each test. The tier-1 command runs six test
processes on the host's cores, and torch's default of a thread a core
in each of them oversubscribes the host several times over; at these
tiny widths one thread is as fast even alone. Import it into a test
module's namespace to use it:

    from torch_threads import one_torch_thread  # noqa: F401
"""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
