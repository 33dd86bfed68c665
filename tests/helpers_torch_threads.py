"""The intra-op threads of the port's CPU tests.

The suite runs in 6 worker processes on 8 CPUs. PyTorch's CPU kernels
start one OpenMP thread per CPU in each process, and OpenMP threads spin
while they wait at a barrier: with 48 threads on 8 CPUs a micro model's
training step ran 37x slower than alone (``tests/test_torch_checkpoint.py``'s
round trip: 315 s against 8.5 s, six copies side by side), with 4 threads
a process 10x (80 s), with 2 threads not at all (8.4 s). So every port test
module runs on ``PORT_THREADS`` threads: import ``port_threads`` into the
module (an autouse fixture of module scope), and run the parity steps that
must be reproducible (the auto-mask sees the convolutions' rounding, which
depends on the thread count) inside ``fixed_threads()``.
"""
import contextlib

import pytest
import torch

PORT_THREADS = 2


@contextlib.contextmanager
def fixed_threads(n: int = PORT_THREADS):
    """The block on ``n`` intra-op threads, the count restored after it."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture(autouse=True, scope="module")
def port_threads():
    with fixed_threads():
        yield
