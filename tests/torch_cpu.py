"""Torch's CPU threads for the port's tests: every ``tests/test_torch_*.py``
imports this module first.

The tests run under pytest-xdist, one process a worker. Torch's default is
a thread for every CPU in each of them, so six workers on eight CPUs would
spin 48 threads that take turns on eight. Here each worker gets its share of
the CPUs (``os.cpu_count() // PYTEST_XDIST_WORKER_COUNT``, at least one; all
of them when pytest runs alone), and ``OMP_NUM_THREADS`` says the same to
the processes the tests start (the CLIs, the ranks of the parallel tests).
"""

import os

import torch

WORKERS = max(1, int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
THREADS = max(1, (os.cpu_count() or 1) // WORKERS)

os.environ["OMP_NUM_THREADS"] = str(THREADS)
torch.set_num_threads(THREADS)
