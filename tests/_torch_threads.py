"""A fixture for the port's CPU test files that hold whole solves."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side on one CPU thread: at these sizes every op is a few
    microseconds of work, and with the suite's workers sharing the cores a
    multi-threaded op waits milliseconds for its threads.  Restored after
    the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
