"""The port's sequence parallelism (parallel/sp.py) over SSG and MSG
against the JAX package's ``make_sp_train_step``, on the CPU: four
gloo ranks (tests/torch_ranks.py's ``sp_pointnet`` job, spawned once)
against the JAX step on four of the conftest's virtual devices under
``shard_map``.

Both in the whole-input contract: the queries sliced, FPS whole on every
rank, the logits gathered (BriStruNet's case is
tests/test_torch_parallel_sp_bristrunet.py). The tests, their seeded
weights, skewed batch and bands are tests/test_torch_parallel_sp.py's,
run here over this file's CASES.
"""

import torch_cpu  # noqa: F401  (first: torch's threads a worker)

import pytest

from test_torch_parallel_sp import (  # noqa: F401  (the tests, collected here too)
    pytest_generate_tests,
    run_cases,
    test_sp_forward_and_eval_match_the_single_process_model,
    test_sp_loss_is_the_global_weighted_loss,
    test_sp_ranks_hold_the_same_step,
    test_sp_step_matches_jax,
)
from torch_ranks import SP_POINTNET

MODELS = list(SP_POINTNET)
CASES = MODELS
JOB = "sp_pointnet"


@pytest.fixture(scope="module")
def sp(request, tmp_path_factory):
    return run_cases(request.module, tmp_path_factory)
