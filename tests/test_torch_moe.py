"""The PyTorch port's Mixture of Experts (models/moe.py) and ``ptv3_moe``
against the JAX package, on the CPU.

The JAX MoEFeedForward takes its default one-hot dispatch; the port
dispatches by index, the same function. Outputs agree to 2e-4 (matmul
reassociation), and the routing exactly: the JAX picks and kept slots are
those of pointcloud_bridge_tpu/models/moe.py's own formulas (:161-190)
applied to the JAX router's logits, captured from the flax module. The train
step of ``ptv3_moe`` is held to the JAX float32 and float64 steps with the
method and bands of tests/test_torch_ptv3_train.py.
"""

import torch_cpu  # noqa: F401  (first: torch's threads a worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_bridge_tpu.models import get_model as jax_get_model
from pointcloud_bridge_tpu.models import moe as jmoe
from pointcloud_bridge_tpu_torch.models import MoEFeedForward, get_model, upcycle_dense_to_moe
from pointcloud_bridge_tpu_torch.models.moe import _group_size, capacity
from pointcloud_bridge_tpu_torch.utils.weights import (
    flax_to_state_dict,
    ptv3_moe_rules,
    ptv3_rules,
    rules_for,
    state_dict_to_flax,
)

from test_torch_bristrunet import randomize
from test_torch_ptv3_train import CLASS_WEIGHTS, NO_DROPOUT, _batch, _check, _jax_step, _leaves

MODULE_TOL = 2e-4
MOE = dict(embed_dim=32, depth=2, num_heads=2, num_experts=4)


def _t(a):
    return torch.from_numpy(np.array(a))


def jax_routing(router_logits, top_k, capacity_factor):
    """(picks [G, S, K], kept [G, K*S] rank-major) of the JAX module's own
    formulas (moe.py:161-190) on its router's logits [G, S, E]."""
    probs = jax.nn.softmax(router_logits, axis=-1)
    e = probs.shape[-1]
    g, s = probs.shape[:2]
    sel, masked = [], probs
    for _ in range(top_k):
        idx = jnp.argmax(masked, axis=-1)
        sel.append(idx)
        masked = masked * (1.0 - jax.nn.one_hot(idx, e, dtype=probs.dtype))
    sel = jnp.stack(sel, axis=-1)
    c = max(8, int(-(-top_k * s * capacity_factor // e)))
    c = min(-(-c // 8) * 8, top_k * s)
    mask = jax.nn.one_hot(sel, e, dtype=jnp.float32).transpose(0, 2, 1, 3).reshape(g, top_k * s, e)
    pos = jnp.cumsum(mask, axis=1) - mask
    kept = (mask * (pos < c)).sum(-1) > 0
    return np.asarray(sel), np.asarray(kept)


def run_moe(top_k, capacity_factor, seed=0):
    """The JAX and the port's MoEFeedForward (4 experts, 32 wide, hidden 64)
    on one input of 2 x 256 tokens (one group of 512) with the same weights
    -> (port output, JAX output, port module, JAX picks, JAX kept)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 256, 32)).astype(np.float32)
    jm = jmoe.MoEFeedForward(4, 64, 32, top_k=top_k, capacity_factor=capacity_factor)
    variables = randomize(jax.jit(lambda a: jm.init(jax.random.PRNGKey(seed), a))(x))
    # the router's fresh weights are small: spread the picks over the experts
    variables["params"]["router"]["kernel"] *= 20.0
    (want, state) = jax.jit(lambda v, a: jm.apply(v, a, capture_intermediates=True))(
        variables, x)
    logits = state["intermediates"]["router"]["__call__"][0]
    sel, kept = jax_routing(logits, top_k, capacity_factor)
    tm = MoEFeedForward(4, 64, 32, top_k=top_k, capacity_factor=capacity_factor)
    rules = [("experts", (), "experts"), ("router", ("router",), "dense")]
    sd = {k.removeprefix("experts."): v for k, v in flax_to_state_dict(variables, rules).items()}
    tm.load_state_dict(sd, strict=True)
    tm.eval()
    with torch.inference_mode():
        got = tm(_t(x))
    return got, np.asarray(want), tm, sel, kept


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_feed_forward_matches_jax(top_k):
    got, want, tm, sel, kept = run_moe(top_k, 1.25)
    np.testing.assert_array_equal(tm.routing["sel"].numpy(), sel)
    np.testing.assert_array_equal((tm.routing["slot"] < 4 * capacity(512, 4, top_k, 1.25)).numpy(),
                                  kept)
    assert len(np.unique(sel[..., 0])) == 4  # every expert takes tokens
    assert np.abs(want).max() > 1e-1
    np.testing.assert_allclose(got.numpy(), want, rtol=MODULE_TOL, atol=MODULE_TOL)
    assert torch.isfinite(tm.aux_loss) and tm.aux_loss.item() >= 1.0 - 1e-6


def test_capacity_drops_choices_as_jax_does():
    """A capacity factor of 0.25 leaves 64 slots an expert for 512 tokens at
    top 2: most choices drop, the same ones in both packages, and a token
    whose every choice dropped gets exactly 0."""
    got, want, tm, sel, kept = run_moe(2, 0.25, seed=1)
    assert capacity(512, 4, 2, 0.25) == 64
    slot = tm.routing["slot"].numpy()
    np.testing.assert_array_equal(slot < 4 * 64, kept)
    assert (~kept).sum() > 256 and kept[:, :512].sum() > kept[:, 512:].sum()
    np.testing.assert_allclose(got.numpy(), want, rtol=MODULE_TOL, atol=MODULE_TOL)
    none_kept = ~(kept[0, :512] | kept[0, 512:])
    assert none_kept.any()
    assert torch.equal(got.reshape(512, 32)[torch.from_numpy(none_kept)],
                       torch.zeros(int(none_kept.sum()), 32))


@pytest.mark.parametrize("total,group", [(512, 512), (1000, 500), (4096 * 16, 512), (7, 7),
                                         (1031, 1)])
def test_group_size_and_capacity_follow_the_jax_module(total, group):
    assert _group_size(total, 512) == jmoe._group_size(total, 512) == group
    for k in (1, 2):
        for cf in (0.25, 1.0, 1.25, 4.0):
            c = max(8, int(-(-k * group * cf // 8)))
            assert capacity(group, 8, k, cf) == min(-(-c // 8) * 8, k * group)


# ------------------------------------------------------------------ ptv3_moe

_BOTH = {}


def both_moe_models(top_k):
    """ptv3_moe at 32 wide, 2 blocks (block 1 MoE), 4 experts, in both
    packages with the same weights, and their eval logits on one input."""
    if top_k not in _BOTH:
        rng = np.random.default_rng(3)
        xyz = rng.uniform(-1.0, 1.0, size=(2, 128, 3)).astype(np.float32)
        rgb = rng.uniform(size=(2, 128, 3)).astype(np.float32)
        kw = dict(MOE, moe_top_k=top_k)
        jmodel = jax_get_model("ptv3_moe", 5, **kw)
        variables = randomize(jax.jit(
            lambda a, b: jmodel.init(jax.random.PRNGKey(0), a, b, train=False))(xyz, rgb))
        variables["params"]["block1"]["moe_mlp"]["router"]["kernel"] *= 20.0
        want = np.asarray(jax.jit(lambda v, a, b: jmodel.apply(v, a, b))(variables, xyz, rgb))
        model = get_model("ptv3_moe", 5, **kw)
        model.load_state_dict(flax_to_state_dict(variables, ptv3_moe_rules(2)), strict=True)
        model.eval()
        with torch.inference_mode():
            got = model(_t(xyz), _t(rgb))
        _BOTH[top_k] = variables, model, got, want
    return _BOTH[top_k]


@pytest.mark.parametrize("top_k", [1, 2])
def test_ptv3_moe_logits_match_jax(top_k):
    _, model, got, want = both_moe_models(top_k)
    assert hasattr(model.block1, "moe_mlp") and hasattr(model.block0, "mlp")
    assert model.block1.moe_mlp.num_experts == 4 and model.block1.moe_mlp.top_k == top_k
    assert got.shape == (2, 128, 5) and want.std(axis=1).min() > 1e-3
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(got.argmax(-1).numpy(), want.argmax(-1))


def test_ptv3_moe_weights_round_trip_is_exact_and_complete():
    variables, model, _, _ = both_moe_models(2)
    rules = ptv3_moe_rules(2)
    back = state_dict_to_flax(model.state_dict(), rules)
    want, got = _leaves(variables), _leaves(back)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert set(flax_to_state_dict(variables, rules)) == set(model.state_dict())
    names = set(model.state_dict())
    assert {"block1.moe_mlp.experts_proj_kernel", "block1.moe_mlp.router.weight"} <= names
    assert "block1.moe_mlp.router.bias" not in names and "block1.mlp.out.weight" not in names


def test_registry_ptv3_moe_rules_cover_the_default_model():
    """``get_model("ptv3_moe", 5)``: the flat model at its defaults with 8
    experts, top 2, in blocks 1, 3, 5 and 7; the registry's rule table
    names every parameter."""
    model = get_model("ptv3_moe", 5, generator=torch.Generator().manual_seed(0))
    moe = [i for i in range(8) if hasattr(getattr(model, f"block{i}"), "moe_mlp")]
    assert moe == [1, 3, 5, 7]
    assert model.block3.moe_mlp.experts_proj_kernel.shape == (8, 384, 2 * 1536)
    assert model.block3.moe_mlp.experts_out_kernel.shape == (8, 1536, 384)
    assert model.block3.moe_mlp.router.weight.shape == (8, 384)
    sd = model.state_dict()
    covered = set()
    for tp, _, kind in rules_for("ptv3_moe"):
        covered |= {k for k in sd if k.startswith(tp + ".") and (
            kind != "experts" or k.removeprefix(tp + ".").startswith("experts_"))}
    assert covered == set(sd)


def test_upcycled_moe_computes_the_dense_model():
    """upcycle_dense_to_moe of a dense ptv3: with a capacity that drops
    nothing the MoE model gives the dense logits; the state_dict equals the
    JAX package's upcycle of the same trees, converted."""
    dense = get_model("ptv3", 5, generator=torch.Generator().manual_seed(1),
                      embed_dim=32, depth=2, num_heads=2).eval()
    moe = get_model("ptv3_moe", 5, generator=torch.Generator().manual_seed(2),
                    embed_dim=32, depth=2, num_heads=2, num_experts=4,
                    moe_capacity_factor=4.0).eval()
    sd = upcycle_dense_to_moe(dense.state_dict(), moe.state_dict())
    moe.load_state_dict(sd, strict=True)
    rng = np.random.default_rng(4)
    xyz = _t(rng.uniform(-1.0, 1.0, size=(2, 128, 3)).astype(np.float32))
    rgb = _t(rng.uniform(size=(2, 128, 3)).astype(np.float32))
    with torch.inference_mode():
        np.testing.assert_allclose(moe(xyz, rgb).numpy(), dense(xyz, rgb).numpy(),
                                   rtol=1e-5, atol=1e-5)
    assert (moe.block1.moe_mlp.routing["slot"] < 4 * capacity(256, 4, 2, 4.0)).all()
    jdense = state_dict_to_flax(dense.state_dict(), ptv3_rules(2))["params"]
    jmoe_tree = state_dict_to_flax(moe.state_dict(), ptv3_moe_rules(2))["params"]
    jmoe_tree["block1"]["moe_mlp"]["router"] = state_dict_to_flax(
        {"block1.moe_mlp.router.weight": moe.block1.moe_mlp.router.weight},
        ptv3_moe_rules(2))["params"]["block1"]["moe_mlp"]["router"]
    want = _leaves(jmoe.upcycle_dense_to_moe(jdense, jmoe_tree))
    got = _leaves(state_dict_to_flax(sd, ptv3_moe_rules(2))["params"])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ------------------------------------------------------- a ptv3_moe train step


@pytest.fixture(scope="module")
def moe_step():
    """(JAX float32, JAX float64, port) results of one ptv3_moe train step
    (4 experts, top 2, 2 blocks) on the batch of test_torch_ptv3_train."""
    from pointcloud_bridge_tpu_torch import losses
    from pointcloud_bridge_tpu_torch.config import Config
    from pointcloud_bridge_tpu_torch.train import make_train_step

    b = _batch()
    jmodel = jax_get_model("ptv3_moe", 5, **MOE)
    # weights whose head pre-activations keep 1e-5 from the ReLU's kink
    # (asserted below): at the kink the two packages' float32 roundings may
    # take either side, and the gradient there is not defined
    variables = randomize(jax.jit(
        lambda x, c: jmodel.init(jax.random.PRNGKey(0), x, c, train=False)
    )(b["points"], b["colors"]), seed=4)
    variables["params"]["block1"]["moe_mlp"]["router"]["kernel"] *= 20.0
    want32 = _jax_step("ptv3_moe", MOE, variables, b, np.float32)
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        want64 = _jax_step("ptv3_moe", MOE, variables, b, np.float64)
    finally:
        jax.config.update("jax_enable_x64", x64)
    rules = ptv3_moe_rules(2)

    def port_model():
        model = get_model("ptv3_moe", 5, **NO_DROPOUT, **MOE)
        model.load_state_dict(flax_to_state_dict(variables, rules), strict=True)
        return model

    tb = {"points": _t(b["points"]), "colors": _t(b["colors"]), "labels": _t(b["labels"]).long()}
    cw = _t(CLASS_WEIGHTS)
    model = port_model().train()
    head_in = []
    hook = model.head_bn.register_forward_hook(lambda m, i, o: head_in.append(o.detach()))
    logits = model(tb["points"], tb["colors"])
    hook.remove()
    assert head_in[0].abs().min() > 1e-5
    loss = losses.weighted_cross_entropy(logits, tb["labels"], cw)
    loss.backward()
    sgd_model = port_model()
    metrics = make_train_step(sgd_model, Config().loss, torch.optim.SGD(
        sgd_model.parameters(), lr=0.1))(tb, 0.1, cw)
    to64 = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), t)  # noqa: E731
    grads = {k: p.grad for k, p in model.named_parameters()}
    got = {
        "loss": float(loss.detach()),
        "sgd_loss": float(metrics["loss"]),
        "logits": logits.detach().double().numpy(),
        "grads": to64(state_dict_to_flax(grads, rules)["params"]),
        "batch_stats": to64(state_dict_to_flax(model.state_dict(), rules)["batch_stats"]),
        "sgd_params": to64(state_dict_to_flax(sgd_model.state_dict(), rules)["params"]),
    }
    return want32, want64, got


def test_ptv3_moe_train_step_matches_jax(moe_step):
    want32, want64, got = moe_step
    np.testing.assert_allclose(got["loss"], want32["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["sgd_loss"], want32["loss"], rtol=1e-5)
    _check("logits", lambda r: 2e-4, moe_step)
    grads = _leaves(want64["grads"])
    assert any("moe_mlp" in k and "experts_proj_kernel" in k for k in grads)
    _check("grads", lambda r: 2e-4 * np.abs(r).max() + 1e-6, moe_step)
    _check("batch_stats", lambda r: 1e-5 * np.abs(r).max(), moe_step)
    _check("sgd_params", lambda r: 1e-6, moe_step)
