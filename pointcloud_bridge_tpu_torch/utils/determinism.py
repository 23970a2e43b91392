"""Determinism helpers (counterpart of pointcloud_bridge_tpu/utils/
determinism.py:13-22, itself the reference's utils/misc.py:63-88
``set_random_seed``).

The JAX package seeds the host generators and returns a root PRNG key; the
port seeds the host generators and torch's, and returns a seeded
``torch.Generator`` in the key's place. A CUDA graph of train steps
(train/loop.py::GraphSteps) repeats the bits of the eager steps it
captures, so determinism on the card is a matter of the eager ops: the
hand-written kernels are deterministic by design (PERF.md), and
``deterministic=True`` asks PyTorch's own ops for their deterministic forms.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def set_random_seed(seed: int, deterministic: bool = True) -> torch.Generator:
    """Seed Python's, numpy's and torch's generators (the CPU's and every
    CUDA device's) -> a CPU ``torch.Generator`` seeded with ``seed``.

    ``deterministic=True`` also turns on
    ``torch.use_deterministic_algorithms(True, warn_only=True)``: an op
    with a deterministic CUDA form takes it, and one without warns instead
    of raising (chip_smoke.py --graphs lists the ops that warn in the
    port's train steps on the card), cuDNN's benchmark off and its
    deterministic mode on. cuBLAS keeps its results fixed only with a fixed
    workspace, so ``CUBLAS_WORKSPACE_CONFIG`` is set to ``:4096:8`` where
    it is unset; it takes effect only if no cuBLAS call has run yet in the
    process. ``deterministic=False`` turns all of that off again (the
    variable stays)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)  # the CPU's and every CUDA device's
    if deterministic:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(deterministic, warn_only=True)
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = deterministic
    return torch.Generator().manual_seed(seed)
