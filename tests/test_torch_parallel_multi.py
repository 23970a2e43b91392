"""The port's K = 2 data-parallel dispatch with the EMA against the JAX
package's ``make_dp_multi_train_step`` (train_step.py:96-170), on the CPU:
two gloo ranks (tests/torch_ranks.py's ``multi`` job, spawned once) against
the JAX dispatch on two virtual devices, with the seeded SSG and the
bands of tests/test_torch_parallel.py; and the port's own contract, a
dispatch of K = 2 equal bit for bit to two dp steps and their EMA
updates (on the CPU the K steps run eagerly; the card replays them as one
CUDA graph, chip_smoke.py phase 43b)."""

import torch_cpu  # noqa: F401  (first: torch's threads a worker)

import numpy as np
import pytest
import torch

from pointcloud_bridge_tpu_torch.utils.weights import state_dict_to_flax

from test_torch_parallel import SGD_BAND, STAT_BAND, check_tree, flax_of, jax_dp_multi
from torch_ranks import Ranks, skewed_batch, ssg, stacked


@pytest.fixture(scope="module")
def multi(tmp_path_factory):
    ranks = Ranks("multi", 2, tmp_path_factory.mktemp("multi")).start()
    variables = state_dict_to_flax(ssg(0).state_dict())
    batches = stacked(skewed_batch(seed=1), skewed_batch(seed=2))
    want32 = jax_dp_multi(variables, batches, np.float32)
    want64 = jax_dp_multi(variables, batches, np.float64)
    return want32, want64, ranks.join()


def test_dp_multi_step_is_k_single_steps(multi):
    """A dispatch of K = 2 is exactly two dp steps and their EMA updates."""
    r0 = multi[2][0]
    assert torch.equal(r0["loss"], r0["single"]["loss"])
    for k, v in r0["state"].items():
        assert torch.equal(v, r0["single"]["state"][k]), k
    for k, v in r0["ema"].items():
        assert torch.equal(v, r0["single"]["ema"][k]), k


def test_dp_multi_step_losses_match_jax(multi):
    """The two steps' losses held to the JAX float64 dispatch within 1e-5
    relative plus twice the JAX float32 dispatch's own error: the second
    step's JAX float32 loss is 1e-3 away from its float64 one, so the
    float32 losses alone cannot be held to each other within 1e-5."""
    want32, want64, (r0, _) = multi
    check_tree({"loss": r0["loss"].double().numpy()}, {"loss": want32["loss"]},
               {"loss": want64["loss"]}, lambda r: 1e-5 * np.abs(r).max(), "loss")


@pytest.mark.parametrize("key,base", [("batch_stats", STAT_BAND), ("sgd_params", SGD_BAND),
                                      ("ema", SGD_BAND)])
def test_dp_multi_step_matches_jax(multi, key, base):
    want32, want64, (r0, _) = multi
    if key == "ema":
        got = flax_of(r0["ema"])["params"]
    else:
        got = flax_of(r0["state"])["batch_stats" if key == "batch_stats" else "params"]
    check_tree(got, want32[key], want64[key], base, key)
