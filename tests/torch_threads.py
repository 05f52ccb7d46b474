"""One intra-op thread for the port's CPU tests.

The suite runs in several worker processes on one host (pytest-xdist).
PyTorch's intra-op pool takes every core in each of them, and at the
tests' small shapes the pools then spin against each other: a B = 2, 64x64
Inception-v1 train step read 3.6 s with one thread and 13 s with eight in
one process, and 242 s with eight in each of six processes side by side
(2.7-3.3 s with one).  A port test module imports `one_intra_op_thread`,
an autouse fixture that runs the module on one thread and gives the
process its previous count back after it.  Spawned ranks set their own
(`parallel.spawn`, `torch_parallel_ranks._join`).
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)
