"""The port's GPipe pipeline (parallel/pp.py) against the JAX package's
``make_pp_train_step``, on the CPU: four gloo ranks (tests/torch_ranks.py's
``pp`` job, spawned once) against the JAX step on four of the conftest's
virtual devices under ``shard_map``.

ptv3 with four blocks, M = 2 microbatches: over a pipeline of four stages
with global attention and with Morton-sorted windows, then over a 2 x 2
("data", "pp") mesh (two blocks a stage, the loss summed over "data"
before the division). Each stage holds its own blocks alone; the
gradients and the state are gathered back to the single-device layout.
Same weights (``state_dict_to_flax``, stacked by the JAX
``stack_ptv3_params``), dropout 0, the skewed batch and the bands of
tests/test_torch_parallel_sp.py. An Adam step's moments come back in the
single-device layout; ``pp_stack_state`` and ``pp_unstack_state`` round
trip a state with its moments, and each stage's stacked state (the layout
its checkpoint travels in) is the part ``pp_place_state`` cuts from
``make_pp_state`` of the gathered model; the JAX step's refusals hold.
"""

import torch_cpu  # noqa: F401  (first: torch's threads a worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_bridge_tpu.config import Config
from pointcloud_bridge_tpu.models import get_model as jax_get_model
from pointcloud_bridge_tpu.parallel import (
    make_mesh,
    make_named_mesh,
    make_pp_train_step,
    pp_place_state,
    shard_batch,
    stack_ptv3_params as jax_stack,
    unstack_ptv3_params as jax_unstack,
)
from pointcloud_bridge_tpu.train.loop import TrainState
from pointcloud_bridge_tpu_torch import losses
from pointcloud_bridge_tpu_torch.models import get_model
from pointcloud_bridge_tpu_torch.parallel import (
    make_pp_state,
    pp_stack_state,
    pp_state_specs,
    pp_unstack_state,
    stack_ptv3_params,
    unstack_ptv3_params,
)
from pointcloud_bridge_tpu_torch.utils.weights import ptv3_rules, state_dict_to_flax

from test_torch_parallel import GRAD_BAND, RECORD, STAT_BAND, cast, check_tree, to64
from torch_ranks import CLASS_WEIGHTS, PP_KW, SGD_LR, Ranks, pp_model, skewed_batch

CASES = ["global", "morton", "dp_x_pp"]
RULES = ptv3_rules(PP_KW["depth"])


def jax_pp_step(case):
    window = 16 if case == "morton" else 0
    variables = cast(state_dict_to_flax(pp_model(window).state_dict(), RULES), np.float32)
    batch = skewed_batch(4, 64)
    feed = {k: batch[k] for k in ("points", "colors", "labels")}
    if case == "dp_x_pp":
        mesh, dp = make_named_mesh((2, 2), ("data", "pp")), "data"
        feed = shard_batch(feed, mesh, "data")
    else:
        mesh, dp = make_mesh(4, "pp"), None
        feed = {k: jnp.asarray(v) for k, v in feed.items()}
    model = jax_get_model("ptv3", num_classes=5, window_size=window, drop_rate=0.0,
                          attn_drop_rate=0.0, head_drop_rate=0.0, **PP_KW)
    params = jax_stack(variables["params"], PP_KW["depth"])
    state = pp_place_state(TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                      batch_stats=variables["batch_stats"],
                                      opt_state=RECORD.init(params)), mesh)
    step = make_pp_train_step(model, Config().loss, RECORD, mesh, state, axis="pp",
                              num_microbatches=2, donate=False, dp_axis=dp)
    state, m = step(state, feed, jnp.float32(SGD_LR), jnp.asarray(CLASS_WEIGHTS),
                    jax.random.PRNGKey(0))
    return to64({"loss": m["loss"], "acc": m["acc"],
                 "grads": jax_unstack(state.opt_state, PP_KW["depth"]),
                 "batch_stats": state.batch_stats})


def single(window):
    """The port's single-process float32 step: loss, gradients, state and
    eval logits (taken first, on the untouched statistics)."""
    batch = skewed_batch(4, 64)
    x, c = torch.from_numpy(batch["points"]), torch.from_numpy(batch["colors"])
    with torch.no_grad():
        eval_logits = pp_model(window).eval()(x, c)
    model = pp_model(window)
    loss = losses.weighted_cross_entropy(model(x, c), torch.from_numpy(batch["labels"]).long(),
                                         torch.from_numpy(CLASS_WEIGHTS))
    loss.backward()
    return {"loss": loss.item(), "grads": {k: p.grad for k, p in model.named_parameters()},
            "state": {k: v.detach() for k, v in model.state_dict().items()},
            "logits": eval_logits}


@pytest.fixture(scope="module")
def pp(tmp_path_factory):
    ranks = Ranks("pp", 4, tmp_path_factory.mktemp("pp"), timeout=240).start()
    jax_out = {case: jax_pp_step(case) for case in CASES}
    singles = {"global": single(0), "morton": single(16)}
    singles["dp_x_pp"] = singles["global"]
    return ranks.join(), jax_out, singles


def flax_tree(tensors):
    return to64(state_dict_to_flax(tensors, RULES))


@pytest.mark.parametrize("case", CASES + ["adam"])
def test_pp_ranks_gather_the_same_state(pp, case):
    r0 = pp[0][0][case]
    for r in pp[0][1:]:
        assert r[case]["loss"] == r0["loss"]
        for key in ("grads", "state"):
            assert list(r[case][key]) == list(r0[key])
            for k, v in r0[key].items():
                assert torch.equal(v, r[case][key][k]), (key, k)


@pytest.mark.parametrize("case", CASES)
def test_pp_stage_holds_its_blocks_alone(pp, case):
    per = PP_KW["depth"] // (2 if case == "dp_x_pp" else 4)
    for rank, r in enumerate(pp[0]):
        stage = rank % 2 if case == "dp_x_pp" else rank
        blocks = {k.split(".")[0] for k in r[case]["local"] if k.startswith("block")}
        assert blocks == {f"block{stage * per + i}" for i in range(per)}
        assert list(r[case]["state"]) == list(pp_model().state_dict())


@pytest.mark.parametrize("case", CASES)
def test_pp_loss_matches_jax_and_the_single_process_loss(pp, case):
    ranks, jax_out, singles = pp
    got = ranks[0][case]["loss"]
    np.testing.assert_allclose(got, jax_out[case]["loss"], rtol=1e-5)
    np.testing.assert_allclose(got, singles[case]["loss"], rtol=1e-5)
    assert abs(ranks[0][case]["acc"] - jax_out[case]["acc"]) <= 1.0 / 64


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("key", ["grads", "batch_stats"])
def test_pp_step_matches_jax(pp, case, key):
    ranks, jax_out, singles = pp
    r0 = ranks[0][case]
    src, part, base = (("grads", "params", GRAD_BAND) if key == "grads"
                       else ("state", "batch_stats", STAT_BAND))
    check_tree(flax_tree(r0[src])[part], flax_tree(singles[case][src])[part],
               jax_out[case][key], base, f"{case} {key}")


def test_pp_forward_matches_the_single_process_model(pp):
    want = pp[2]["global"]["logits"]
    for r in pp[0]:
        assert (r["global"]["forward"] - want).abs().max() <= 1e-4 * want.abs().max()


def test_pp_adam_moments_come_back_in_the_single_device_layout(pp):
    """The gathered optimizer state loads into a single-device Adam over
    the single-device model, and its first moments are the first step's,
    0.1 (g + 1e-4 p) of the gathered gradients."""
    r0 = pp[0][0]["adam"]
    model = pp_model()
    p0 = dict(model.named_parameters())
    opt = torch.optim.Adam(model.parameters())
    opt.load_state_dict(r0["optimizer"])
    names = [k for k, _ in model.named_parameters()]
    assert sorted(r0["optimizer"]["state"]) == list(range(len(names)))
    for i, name in enumerate(names):
        st = r0["optimizer"]["state"][i]
        want = 0.1 * (r0["grads"][name] + 1e-4 * p0[name].detach())
        assert float(st["step"]) == 1.0
        assert (st["exp_avg"] - want).abs().max() <= 1e-6 * want.abs().max() + 1e-12, name


def test_pp_stack_and_unstack_round_trip_a_state_with_its_moments(pp):
    r0 = pp[0][0]["adam"]
    model = pp_model()
    model.load_state_dict(r0["state"])
    opt = torch.optim.Adam(model.parameters())
    opt.load_state_dict(r0["optimizer"])
    stacked = make_pp_state(model, opt)
    depth = PP_KW["depth"]
    assert stacked["model"]["blocks.attn.qkv.weight"].shape[0] == depth
    assert stacked["moments"]["exp_avg"]["blocks.mlp.out.weight"].shape[0] == depth
    specs = pp_state_specs(stacked)
    assert specs["model"]["blocks.norm1.weight"] == "pp" and specs["model"]["head_bn.bias"] is None
    back = pp_unstack_state(stacked, depth)
    for k, v in model.state_dict().items():
        assert torch.equal(back["model"][k], v), k
    for name, p in model.named_parameters():
        for key, v in opt.state[p].items():
            assert torch.equal(back["moments"][name][key], v), (name, key)
    again = pp_stack_state(back, depth)
    assert torch.equal(again["model"]["blocks.attn.proj.bias"],
                       stacked["model"]["blocks.attn.proj.bias"])
    assert unstack_ptv3_params(stack_ptv3_params(r0["state"], depth), depth).keys() == \
        r0["state"].keys()
    with pytest.raises(ValueError, match="homogeneous block stack"):
        stack_ptv3_params(get_model("ptv3_moe", 5, embed_dim=32, depth=2, num_heads=2,
                                    num_experts=2).state_dict(), 2)


def test_pp_stage_state_is_cut_from_the_single_device_state(pp):
    """Each rank's Stages.stacked_state (its blocks and their Adam moments,
    stacked) is what pp_place_state cuts for its stage from make_pp_state
    of the single-device model and optimizer that the stages gathered."""
    for rank, r in enumerate(pp[0]):
        got, want = r["adam"]["stacked"]["stage"], r["adam"]["stacked"]["placed"]
        assert got["model"]["blocks.attn.qkv.weight"].shape[0] == 1
        trees = [("model", got["model"], want["model"])] + [
            (key, got["moments"][key], want["moments"][key]) for key in want["moments"]]
        assert sorted(got["moments"]) == sorted(want["moments"])
        for part, a, b in trees:
            assert sorted(a) == sorted(b), (rank, part)
            for k, v in b.items():
                assert torch.equal(a[k], v), (rank, part, k)


@pytest.mark.parametrize("case,pattern", [
    ("depth", "depth 3 not divisible by 4 stages"),
    ("sp_axis", "PP and SP are separate modes"),
    ("moe", "homogeneous block stack"),
    ("batch", "batch 3 not divisible by num_microbatches 2"),
])
def test_pp_refusals(pp, case, pattern):
    for r in pp[0]:
        assert r["refusals"][case] is not None and pattern in r["refusals"][case]
