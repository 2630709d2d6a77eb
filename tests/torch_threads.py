"""A module-scoped fixture for the port's CPU test files: one torch thread
while the module runs. The suite runs in several worker processes on few
cores; torch's own thread pool in each would oversubscribe them, and the
many small ops of the plain versions then wait on descheduled threads.

Use it by importing it into a test module::

    from torch_threads import one_torch_thread  # noqa: F401
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
