"""One intra-op torch thread while a port test module runs.

Each ``tests/test_torch_*.py`` imports :func:`one_torch_thread`, an
autouse module fixture: the port's tests work on small tensors, and test
workers that run beside each other would otherwise oversubscribe the
cores with torch's default thread pool.  The count is restored when the
module ends, so the other test files of the same worker see the default.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
