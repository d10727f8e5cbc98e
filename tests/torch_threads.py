"""Torch's intra-op threads for the port's CPU test modules. The suite
runs six workers on the host's cores, and at torch's default of a thread
a core each worker's matmuls and convolutions contend with the others'
(tests/test_torch_farm.py measured its paths 5-40x slower at 8 threads
than at 2 there). A test module that imports `few_threads` runs at
THREADS and gives the setting back after its last test."""
import pytest
import torch

THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)
