"""The port's expert parallelism (parallel/ep.py) against the JAX
package's ``make_ep_train_step``, and the whole-scene vote over a device
mesh, on the CPU: two gloo ranks (tests/torch_ranks.py's ``ep`` job,
spawned once) against the JAX GSPMD step on the conftest's virtual devices.

``ptv3_moe`` with two blocks, the second a MoE layer of 4 experts (top 2,
capacity 1.25, so some choices drop), on a 1 x 2 ("data", "expert") mesh
(two experts a rank, the partial outputs summed over "expert") and on a
2 x 1 mesh (the batch split, the group size and capacity from the global
token count, the load-balance loss from the global f_e and p_e). The loss
is the global batch's task loss plus 1e-2 times the mean aux loss, which
is held to the JAX ``_aux_sum`` of the same forward. Same weights, dropout
0, the skewed batch and the bands of tests/test_torch_parallel_sp.py.
"""

import torch_cpu  # noqa: F401  (first: torch's threads a worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_bridge_tpu.config import Config
from pointcloud_bridge_tpu.models import get_model as jax_get_model
from pointcloud_bridge_tpu.parallel import make_ep_mesh, make_ep_train_step
from pointcloud_bridge_tpu.parallel.ep import _aux_sum
from pointcloud_bridge_tpu.train.loop import TrainState
from pointcloud_bridge_tpu_torch import losses
from pointcloud_bridge_tpu_torch.models.moe import MoEFeedForward
from pointcloud_bridge_tpu_torch.utils.weights import ptv3_moe_rules, state_dict_to_flax

from test_torch_parallel import GRAD_BAND, RECORD, STAT_BAND, cast, check_tree, to64
from torch_ranks import CLASS_WEIGHTS, EP_AUX, EP_KW, SGD_LR, Ranks, ep_model, skewed_batch

MESHES = {"1x2": (1, 2), "2x1": (2, 1)}
RULES = ptv3_moe_rules(EP_KW["depth"], 2)
JAX_KW = dict(EP_KW, drop_rate=0.0, attn_drop_rate=0.0, head_drop_rate=0.0)


def jax_ep_step(case):
    variables = cast(state_dict_to_flax(ep_model().state_dict(), RULES), np.float32)
    model = jax_get_model("ptv3_moe", num_classes=5, **JAX_KW)
    step, place = make_ep_train_step(model, Config().loss, RECORD, make_ep_mesh(*MESHES[case]),
                                     aux_coef=EP_AUX)
    params = variables["params"]
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=variables["batch_stats"], opt_state=RECORD.init(params))
    batch = skewed_batch(4, 256)
    state, b = place(state, {k: batch[k] for k in ("points", "colors", "labels")})
    state, m = step(state, b, jnp.float32(SGD_LR), jnp.asarray(CLASS_WEIGHTS),
                    jax.random.PRNGKey(0))
    return to64({"loss": m["loss"], "aux_loss": m["aux_loss"], "acc": m["acc"],
                 "grads": state.opt_state, "batch_stats": state.batch_stats})


def single():
    """The port's single-process float32 step of the same objective (the
    MoE layers keep the aux loss's graph, as under ep), and the JAX
    model's sown aux loss of the same forward."""
    batch = skewed_batch(4, 256)
    x, c = torch.from_numpy(batch["points"]), torch.from_numpy(batch["colors"])
    model = ep_model()
    for m in model.modules():  # keep the aux loss's graph, with no mesh axes
        if isinstance(m, MoEFeedForward):
            m.ep_axes = (None, None)
    logits = model(x, c)
    loss = losses.weighted_cross_entropy(logits, torch.from_numpy(batch["labels"]).long(),
                                         torch.from_numpy(CLASS_WEIGHTS))
    aux = torch.stack([m.aux_loss for m in model.modules() if isinstance(m, MoEFeedForward)
                       and m.aux_loss is not None]).mean()
    (loss + EP_AUX * aux).backward()
    variables = cast(state_dict_to_flax(ep_model().state_dict(), RULES), np.float32)
    _, mutated = jax_get_model("ptv3_moe", num_classes=5, **JAX_KW).apply(
        variables, jnp.asarray(batch["points"]), jnp.asarray(batch["colors"]), train=True,
        mutable=["batch_stats", "intermediates"])
    return {"loss": loss.item(), "aux": aux.item(),
            "jax_aux": float(_aux_sum(mutated["intermediates"])),
            "grads": {k: p.grad for k, p in model.named_parameters()},
            "state": {k: v.detach() for k, v in model.state_dict().items()}}


@pytest.fixture(scope="module")
def ep(tmp_path_factory):
    ranks = Ranks("ep", 2, tmp_path_factory.mktemp("ep"), timeout=180).start()
    jax_out = {case: jax_ep_step(case) for case in MESHES}
    return ranks.join(), jax_out, single()


def flax_tree(tensors):
    return to64(state_dict_to_flax(tensors, RULES))


@pytest.mark.parametrize("case", list(MESHES))
def test_ep_ranks_gather_the_same_state(ep, case):
    r0, r1 = ep[0]
    assert r0[case]["loss"] == r1[case]["loss"] and r0[case]["aux_loss"] == r1[case]["aux_loss"]
    for key in ("grads", "state"):
        for k, v in r0[case][key].items():
            assert torch.equal(v, r1[case][key][k]), (key, k)


def test_ep_keeps_a_ranks_experts_alone(ep):
    for r in ep[0]:
        for k, shape in r["1x2"]["local"].items():
            full = r["1x2"]["grads"][k].shape
            if "experts_" in k:
                assert shape[0] * 2 == full[0] == EP_KW["num_experts"] and shape[1:] == full[1:]
            else:
                assert shape == full, k
        assert r["2x1"]["local"] == {k: tuple(v.shape) for k, v in r["2x1"]["grads"].items()}


@pytest.mark.parametrize("case", list(MESHES))
def test_ep_losses_match_jax(ep, case):
    """The task loss of the global batch and the mean aux loss, against
    the JAX step's and the single-process values; the single-process aux
    loss against the JAX model's sown one."""
    ranks, jax_out, s = ep
    got = ranks[0][case]
    np.testing.assert_allclose(got["loss"], jax_out[case]["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["loss"], s["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["aux_loss"], jax_out[case]["aux_loss"], rtol=1e-5)
    np.testing.assert_allclose(got["aux_loss"], s["aux"], rtol=1e-5)
    np.testing.assert_allclose(s["aux"], s["jax_aux"], rtol=1e-5)
    assert abs(got["acc"] - jax_out[case]["acc"]) <= 1.0 / 1024


@pytest.mark.parametrize("case", list(MESHES))
@pytest.mark.parametrize("key", ["grads", "batch_stats"])
def test_ep_step_matches_jax(ep, case, key):
    """Held to the JAX step, the port's single-process step of the same
    objective (task + 1e-2 aux) as the near reference."""
    ranks, jax_out, s = ep
    src, part, base = (("grads", "params", GRAD_BAND) if key == "grads"
                       else ("state", "batch_stats", STAT_BAND))
    check_tree(flax_tree(ranks[0][case][src])[part], flax_tree(s[src])[part],
               jax_out[case][key], base, f"{case} {key}")


def test_ep_refuses_a_rank_that_would_split_a_token_group(ep):
    for r in ep[0]:
        assert "do not hold whole groups of 256" in r["split_group"]["refused"]


def test_the_vote_over_a_mesh_is_the_single_rank_vote(ep):
    """whole_scene_vote_predict with a "data" mesh of two ranks (batch 3
    rounded up to 4, a short batch padded) gives every rank the
    single-rank predictions and vote pool."""
    for r in ep[0]:
        np.testing.assert_array_equal(r["vote"]["mesh"], r["vote"]["single"])
        np.testing.assert_allclose(*r["vote"]["pools"], rtol=0, atol=1e-12)
