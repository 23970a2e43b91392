"""The port's FSDP step (FSDP2 over two gloo ranks) against the JAX
package's ``make_fsdp_train_step`` on ``make_fsdp_mesh(2)``, on the CPU,
with the seeded SSG, skewed batch and bands of
tests/test_torch_parallel.py. The loss is the global batch's; each rank
holds about half of every leaf of at least ``1 << 12`` elements and of its
Adam moments, across two steps; Adam on the sharded leaves is optax's on
the same gradients; the gathered state round-trips through the flax-name
rules bit for bit."""

import torch_cpu  # noqa: F401  (first: torch's threads a worker)

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pointcloud_bridge_tpu.config import Config
from pointcloud_bridge_tpu.parallel import make_fsdp_mesh, make_fsdp_train_step
from pointcloud_bridge_tpu_torch.utils.weights import flax_to_state_dict, state_dict_to_flax

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
from test_torch_parallel_tp import global_loss
from torch_ranks import ADAM_LR, CLASS_WEIGHTS, SGD_LR, Ranks, skewed_batch, ssg


def jax_fsdp_step(variables, batch, dtype):
    def run():
        step, place = make_fsdp_train_step(jax_model(dtype, axis=None), Config().loss, RECORD,
                                           make_fsdp_mesh(2))
        state, b = place(jax_state(variables, dtype), cast(batch, dtype))
        state, m = step(state, b, jnp.asarray(SGD_LR, dtype), jnp.asarray(CLASS_WEIGHTS, dtype),
                        jax.random.PRNGKey(0))
        return to64({"loss": m["loss"], "acc": m["acc"], "grads": state.opt_state,
                     "batch_stats": state.batch_stats, "sgd_params": state.params})
    return in_dtype(run, dtype)


@pytest.fixture(scope="module")
def fsdp(tmp_path_factory):
    ranks = Ranks("fsdp", 2, tmp_path_factory.mktemp("fsdp")).start()
    variables = state_dict_to_flax(ssg(0).state_dict())
    b = skewed_batch()
    return jax_fsdp_step(variables, b, np.float32), jax_fsdp_step(variables, b, np.float64), \
        ranks.join()


def test_fsdp_loss_is_the_global_batchs(fsdp):
    """The loss held to the JAX float64 step within 1e-5 relative plus
    twice the JAX float32 step's own error, and within 1e-5 of the port's
    single-process weighted loss of the whole batch."""
    want32, want64, ranks = fsdp
    whole = global_loss()
    for r in ranks:
        check_tree({"loss": np.float64(r["loss"])}, {"loss": want32["loss"]},
                   {"loss": want64["loss"]}, lambda x: 1e-5 * np.abs(x).max(), "loss")
        np.testing.assert_allclose(r["loss"], whole, rtol=1e-5)
        assert abs(r["acc"] - want32["acc"]) <= 1.0 / (4 * 128)


@pytest.mark.parametrize("key,base", [("grads", GRAD_BAND), ("batch_stats", STAT_BAND),
                                      ("sgd_params", SGD_BAND)])
def test_fsdp_step_matches_jax(fsdp, key, base):
    want32, want64, (r0, r1) = fsdp
    if key == "grads":
        got = flax_of(r0["grads"])["params"]
    else:
        got = flax_of(r0["state"])["batch_stats" if key == "batch_stats" else "params"]
    check_tree(got, want32[key], want64[key], base, key)
    for k, v in r0["state"].items():
        assert torch.equal(v, r1["state"][k]), k


def test_fsdp_holds_half_of_every_large_leaf_across_steps(fsdp):
    """After each of two Adam steps every parameter of at least 1 << 12
    elements and both its moments are DTensors of which a rank holds about
    half (FSDP2 pads dim 0 to the mesh)."""
    for r in fsdp[2]:
        for step in r["adam"]:
            assert step["dtensors"]
            shares = step["shares"]
            params = [k for k in shares if not k.endswith(("exp_avg", "exp_avg_sq"))]
            assert len(params) >= 10
            for k in params:
                assert k + ".exp_avg" in shares and k + ".exp_avg_sq" in shares, k
            for k, share in shares.items():
                assert abs(share - 0.5) <= 0.5 / 16, (k, share)


@pytest.mark.parametrize("i", [0, 1])
def test_fsdp_adam_matches_optax_on_the_gathered_gradients(fsdp, i):
    adam = fsdp[2][0]["adam"]
    names = list(adam[0]["grads"])
    opt = optax.chain(optax.add_decayed_weights(1e-4), optax.scale_by_adam(b1=0.9, b2=0.999))
    params = [jnp.asarray(adam[0]["before"][k].numpy()) for k in names]
    state = opt.init(params)
    for step in adam[:i + 1]:
        upd, state = opt.update([jnp.asarray(step["grads"][k].numpy()) for k in names], state,
                                params)
        params = [p - ADAM_LR * u for p, u in zip(params, upd)]
    for k, p in zip(names, params):
        np.testing.assert_allclose(adam[i]["after"][k].numpy(), np.asarray(p), rtol=0,
                                   atol=1e-6, err_msg=k)


def test_fsdp_gathered_weights_round_trip(fsdp):
    """Every parameter and running statistic of the gathered state through
    the flax-name rules and back bit for bit (flax keeps no
    ``num_batches_tracked``)."""
    sd = fsdp[2][1]["state"]
    back = flax_to_state_dict(state_dict_to_flax(sd))
    assert set(back) == set(sd)
    for k, v in sd.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(torch.as_tensor(np.asarray(back[k])), v), k
