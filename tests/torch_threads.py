"""An autouse fixture for the port's long test files: torch on one
intra-op thread while the module runs.  The suite runs six xdist
workers on as many cores, and each worker's torch would start a thread
a core; on these tests' small tensors the threads then spin against the
other workers' (a reduced model's paged decode call took ~145 ms with
eight threads under that load and ~1 ms with one).  A test module
imports ``one_thread`` to have it."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
