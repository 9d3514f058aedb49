"""Fixtures shared by the port's tests (tests/test_torch_*.py)."""

import pytest
import torch


@pytest.fixture
def one_torch_thread():
    """One intra-op thread while the test runs. The wavefront walk issues
    ~80 tiny torch ops per step; with several test workers each running a
    full thread pool on the same cores, those ops spend far longer
    synchronising threads than computing (a 6-worker run took ~50x the
    single-process time). The walk is elementwise, so its results do not
    depend on the thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
