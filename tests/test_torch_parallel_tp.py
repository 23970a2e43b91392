"""The port's tensor-parallel step on a 2 x 2 ("data", "model") mesh
against the JAX package's ``make_tp_train_step``, on the CPU: four gloo
ranks (tests/torch_ranks.py) against the JAX step on ``make_2d_mesh(2,
2)``, the same seeded SSG, skewed batch and bands as
tests/test_torch_parallel.py. The JAX step is the logical single-device
program, so its loss is the global batch's weighted loss; the port's must
be too, with at least 5 kernels split over "model"."""

import torch_cpu  # noqa: F401  (first: torch's threads a worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_bridge_tpu.config import Config
from pointcloud_bridge_tpu.parallel import make_2d_mesh, make_tp_train_step
from pointcloud_bridge_tpu_torch import losses
from pointcloud_bridge_tpu_torch.utils.weights import state_dict_to_flax

from test_torch_parallel import (
    GRAD_BAND,
    RECORD,
    SGD_BAND,
    STAT_BAND,
    cast,
    check_tree,
    flax_of,
    in_dtype,
    jax_model,
    jax_state,
    to64,
)
from torch_ranks import CLASS_WEIGHTS, SGD_LR, Ranks, skewed_batch, ssg


def jax_tp_step(variables, batch, dtype):
    def run():
        step, place = make_tp_train_step(jax_model(dtype, axis=None), Config().loss, RECORD,
                                         make_2d_mesh(2, 2))
        state, b = place(jax_state(variables, dtype), cast(batch, dtype))
        state, m = step(state, b, jnp.asarray(SGD_LR, dtype), jnp.asarray(CLASS_WEIGHTS, dtype),
                        jax.random.PRNGKey(0))
        return to64({"loss": m["loss"], "acc": m["acc"], "grads": state.opt_state,
                     "batch_stats": state.batch_stats, "sgd_params": state.params})
    return in_dtype(run, dtype)


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    ranks = Ranks("tp", 4, tmp_path_factory.mktemp("tp")).start()
    variables = state_dict_to_flax(ssg(0).state_dict())
    b = skewed_batch()
    return jax_tp_step(variables, b, np.float32), jax_tp_step(variables, b, np.float64), \
        ranks.join()


def global_loss():
    b = skewed_batch()
    logits = ssg(0).train()(torch.from_numpy(b["points"]), torch.from_numpy(b["colors"]))
    return float(losses.weighted_cross_entropy(
        logits, torch.from_numpy(b["labels"]).long(), torch.from_numpy(CLASS_WEIGHTS)))


def test_tp_splits_at_least_5_kernels_over_model(tp):
    for r in tp[2]:
        assert len(r["sharded"]) >= 5
        for k in r["sharded"]:
            assert r["local_shapes"][k][0] * 2 == r["full_shapes"][k][0], k
            assert r["local_shapes"][k][1:] == r["full_shapes"][k][1:], k
        for k in set(r["full_shapes"]) - set(r["sharded"]):
            assert r["local_shapes"][k] == r["full_shapes"][k], k


def test_tp_loss_is_the_global_batchs(tp):
    """The loss held to the JAX float64 step within 1e-5 relative plus
    twice the JAX float32 step's own error, and within 1e-5 of the port's
    single-process weighted loss of the whole batch."""
    want32, want64, ranks = tp
    whole = global_loss()
    for r in ranks:
        check_tree({"loss": np.float64(r["loss"])}, {"loss": want32["loss"]},
                   {"loss": want64["loss"]}, lambda x: 1e-5 * np.abs(x).max(), "loss")
        np.testing.assert_allclose(r["loss"], whole, rtol=1e-5)
        assert abs(r["acc"] - want32["acc"]) <= 1.0 / (4 * 128)


def test_tp_ranks_gather_the_same_state(tp):
    r0 = tp[2][0]
    for r in tp[2][1:]:
        for key in ("grads", "state"):
            for k, v in r0[key].items():
                assert torch.equal(v, r[key][k]), (key, k)


@pytest.mark.parametrize("key,base", [("grads", GRAD_BAND), ("batch_stats", STAT_BAND),
                                      ("sgd_params", SGD_BAND)])
def test_tp_step_matches_jax(tp, key, base):
    want32, want64, (r0, *_) = tp
    if key == "grads":
        got = flax_of(r0["grads"])["params"]
    else:
        got = flax_of(r0["state"])["batch_stats" if key == "batch_stats" else "params"]
    check_tree(got, want32[key], want64[key], base, key)
