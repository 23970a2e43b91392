"""The PyTorch port's PointNet family against the JAX package, on the CPU:
``pointnet`` (``pointnet_seg``), ``pointnet_global``, ``pointnet_sem_seg``
and ``pointnet_cls``.

As tests/test_torch_cls_models.py: the JAX model initialised from a seed,
its BatchNorms moved away from the identity, its variables converted with
the port's utils/weights.py and loaded strictly; eval logits within 2e-4.
Then one train-mode step of ``pointnet`` and ``pointnet_sem_seg`` (weighted
CE, dropout 0) held to the JAX float32 and float64 steps with the method of
tests/test_torch_msg_train.py: each quantity within a base band of the
float64 step plus twice the JAX float32 step's own error on that leaf, the
biases in front of a train-mode BatchNorm (exactly zero gradients) held
structurally; ``pointnet_global``'s shared ``mlp64_bn``, updated twice in
one train-mode call; the weight round trips; and a state_dict in the
reference's layout through the JAX ``convert_state_dict`` and back.
"""

import torch_cpu  # noqa: F401  (first: torch's threads a worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_bridge_tpu import losses as JL
from pointcloud_bridge_tpu.models import get_model as jax_get_model
from pointcloud_bridge_tpu.utils.torch_import import convert_state_dict
from pointcloud_bridge_tpu_torch import losses
from pointcloud_bridge_tpu_torch.models import get_model
from pointcloud_bridge_tpu_torch.models.pointnet import PointNetGlobalSeg
from pointcloud_bridge_tpu_torch.utils.weights import flax_to_state_dict, state_dict_to_flax

from test_torch_bristrunet import randomize
from test_torch_ssg import randomize_bn

# (name, B, N, feature channels beside xyz, or 0 for none)
CASES = [("pointnet", 2, 256, 3), ("pointnet_seg", 2, 200, 0), ("pointnet_global", 2, 256, 3),
         ("pointnet_sem_seg", 2, 256, 6), ("pointnet_cls", 2, 256, 0),
         ("pointnet_cls", 3, 128, 3)]
IDS = [f"{n}_B{b}_N{p}_{c}ch" for n, b, p, c in CASES]
PER_POINT = {"pointnet", "pointnet_seg", "pointnet_global", "pointnet_sem_seg"}


def port_kwargs(name, c):
    """The port's width argument: the JAX models read the features' width
    off their input, the port's take it when built."""
    if name == "pointnet_global":
        return {}
    if name in ("pointnet", "pointnet_seg"):
        return {"in_features": c or 3}  # features None: xyz stands in
    return {"in_features": c}


def inputs(b, n, c, seed=11):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1.0, 1.0, size=(b, n, 3)).astype(np.float32)
    feats = rng.uniform(size=(b, n, c)).astype(np.float32) if c else None
    return xyz, feats


def jax_variables(name, c, seed, bn=randomize_bn):
    """Variables of a seeded port model as the JAX tree (the JAX package's
    init, eager, costs seconds a model; its tree is held to these by
    ``test_weights_round_trip_exactly_and_completely``), BatchNorms (or
    every leaf, with ``bn=randomize``) moved off their start."""
    model = get_model(name, 5, generator=torch.Generator().manual_seed(seed),
                      **port_kwargs(name, c))
    return bn(state_dict_to_flax(model.state_dict(), name))


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def case(request):
    name, b, n, c = request.param
    xyz, feats = inputs(b, n, c)
    jmodel = jax_get_model(name, 5)
    x, f = jnp.asarray(xyz), None if feats is None else jnp.asarray(feats)
    variables = jax_variables(name, c, 0)
    want = np.asarray(jmodel.apply(variables, x, f, train=False))
    return name, c, variables, xyz, feats, want


def test_eval_logits_match_jax(case):
    name, c, variables, xyz, feats, want = case
    model = get_model(name, 5, **port_kwargs(name, c))
    model.load_state_dict(flax_to_state_dict(variables, name), strict=True)
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(xyz), None if feats is None else torch.from_numpy(feats))
    assert got.shape == want.shape == (xyz.shape[:2] if name in PER_POINT
                                       else xyz.shape[:1]) + (5,)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_weights_round_trip_exactly_and_completely(case):
    name, c, variables, xyz, feats, _ = case
    # the JAX model's own tree, traced without running its init
    f = None if feats is None else jnp.asarray(feats)
    tree = jax.eval_shape(lambda: jax_get_model(name, 5).init(
        jax.random.PRNGKey(0), jnp.asarray(xyz), f, train=False))
    assert ({jax.tree_util.keystr(p): leaf.shape
             for p, leaf in jax.tree_util.tree_leaves_with_path(tree)}
            == {jax.tree_util.keystr(p): np.shape(leaf)
                for p, leaf in jax.tree_util.tree_leaves_with_path(variables)})
    sd = flax_to_state_dict(variables, name)
    assert set(sd) == set(get_model(name, 5, **port_kwargs(name, c)).state_dict())
    back = state_dict_to_flax(sd, name)
    want = jax.tree_util.tree_leaves_with_path(variables)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], np.asarray(leaf))


@pytest.mark.parametrize("name,c", [("pointnet", 3), ("pointnet_sem_seg", 6)])
def test_reference_layout_through_convert_state_dict_bit_for_bit(name, c):
    """A state_dict in the reference's layout (Conv1d [O, I, 1], Linear
    [O, I]; the port's own, seeded) through the JAX ``convert_state_dict``
    (strict: every key used) and the port's ``flax_to_state_dict`` comes
    back bit for bit, and the JAX model on those variables gives the port's
    logits."""
    model = get_model(name, 5, in_features=c, generator=torch.Generator().manual_seed(3))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    variables = convert_state_dict(name, {k: v.numpy() for k, v in sd.items()}, strict=True)
    back = flax_to_state_dict(variables, name)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].shape == v.shape, k
        assert torch.equal(back[k].to(v.dtype), v), k
    xyz, feats = inputs(2, 128, c, seed=5)
    want = jax_get_model(name, 5).apply(variables, jnp.asarray(xyz), jnp.asarray(feats),
                                        train=False)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(xyz), torch.from_numpy(feats))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_global_seg_updates_its_shared_batchnorm_twice():
    """``mlp64_bn`` runs twice a call with the same weights; in train mode
    flax updates its statistics twice, the second from the first one's
    result. The port's statistics after one train-mode call equal the JAX
    package's, every BatchNorm's, within 1e-4 * max|stat| (chip_smoke.py's
    band for train-mode statistics), and differ from a single update. B = 8:
    the T-Nets' and the head's FC BatchNorms normalise over the batch alone,
    and over two clouds they amplify float32 rounding to percents."""
    xyz, _ = inputs(8, 128, 0, seed=7)
    jmodel = jax_get_model("pointnet_global", 5)
    variables = jax_variables("pointnet_global", 0, 1, randomize)
    _, mut = jax.jit(lambda v, x: jmodel.apply(v, x, None, train=True, mutable=["batch_stats"],
                                               rngs={"dropout": jax.random.PRNGKey(2)}))(
        variables, jnp.asarray(xyz))
    model = get_model("pointnet_global", 5, dropout_rate=0.0)
    model.load_state_dict(flax_to_state_dict(variables, "pointnet_global"), strict=True)
    before = model.mlp64_bn.running_mean.clone()
    model.train()(torch.from_numpy(xyz))
    assert int(model.mlp64_bn.num_batches_tracked) == 2
    got = state_dict_to_flax(model.state_dict(), "pointnet_global")["batch_stats"]
    for path, leaf in jax.tree_util.tree_leaves_with_path(mut["batch_stats"]):
        port = dict(jax.tree_util.tree_leaves_with_path(got))[path]
        np.testing.assert_allclose(port, np.asarray(leaf), rtol=0,
                                   atol=1e-4 * np.abs(np.asarray(leaf)).max())
    # one update of mlp64_bn would leave 0.9 of `before` in its mean
    once = PointNetGlobalSeg(dropout_rate=0.0)
    once.load_state_dict(flax_to_state_dict(variables, "pointnet_global"), strict=True)
    with torch.no_grad():
        h = torch.relu(once.bn1(once.conv1(torch.bmm(torch.from_numpy(xyz),
                                                      once.eval().stn(torch.from_numpy(xyz))))))
        batch_mean = once.mlp64_dense0(h).reshape(-1, 64).mean(0)
    single = 0.9 * before + 0.1 * batch_mean
    assert not torch.allclose(model.mlp64_bn.running_mean, single, rtol=1e-3, atol=1e-4)


# ------------------------------------------------------------ train steps

SGD_LR = 0.1
# flax layers whose output is no BatchNorm's input: the heads' last convs
# and each T-Net's fc3
NOT_PRE_BN = {"seg_conv4", "head4", "fc3"}


def _jax_step(name, variables, b, dtype):
    jmodel = jax_get_model(name, 5, **({"dropout_rate": 0.0} if name == "pointnet" else {}))
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), variables)
    x, f = np.asarray(b["points"], dtype), np.asarray(b["colors"], dtype)
    cw = np.asarray(b["cw"], dtype)

    def loss_fn(params, stats, x, f, labels, cw):
        logits, mut = jmodel.apply({"params": params, "batch_stats": stats}, x, f, train=True,
                                   mutable=["batch_stats"])
        return JL.weighted_cross_entropy(logits, labels, cw), (logits, mut["batch_stats"])

    (loss, (logits, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"], v["batch_stats"], x, f, b["labels"], cw)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), {
        "loss": loss, "logits": logits, "grads": grads, "batch_stats": stats})


@pytest.fixture(scope="module", params=[("pointnet", 3), ("pointnet_sem_seg", 6)],
                ids=["pointnet", "pointnet_sem_seg"])
def step(request):
    name, c = request.param
    rng = np.random.default_rng(4)
    xyz = rng.uniform(-1.0, 1.0, size=(4, 128, 3)).astype(np.float32)
    b = {"points": xyz, "colors": rng.uniform(size=(4, 128, c)).astype(np.float32),
         "labels": rng.integers(0, 5, size=(4, 128)).astype(np.int32),
         "cw": (0.5 + rng.uniform(size=5)).astype(np.float32)}
    seeded = get_model(name, 5, in_features=c, generator=torch.Generator().manual_seed(0))
    variables = randomize(state_dict_to_flax(seeded.state_dict(), name))
    want32 = _jax_step(name, variables, b, np.float32)
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        want64 = _jax_step(name, variables, b, np.float64)
    finally:
        jax.config.update("jax_enable_x64", x64)
    kwargs = {"dropout_rate": 0.0} if name == "pointnet" else {}
    model = get_model(name, 5, in_features=c, **kwargs)
    model.load_state_dict(flax_to_state_dict(variables, name), strict=True)
    logits = model.train()(torch.from_numpy(xyz), torch.from_numpy(b["colors"]))
    loss = losses.weighted_cross_entropy(logits, torch.from_numpy(b["labels"]).long(),
                                         torch.from_numpy(b["cw"]))
    loss.backward()
    to64 = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), t)  # noqa: E731
    grads = {k: p.grad for k, p in model.named_parameters()}
    return name, want32, want64, {
        "loss": float(loss.detach()), "logits": logits.detach().double().numpy(),
        "grads": to64(state_dict_to_flax(grads, name)["params"]),
        "batch_stats": to64(state_dict_to_flax(model.state_dict(), name)["batch_stats"]),
    }


def _pre_bn_bias(path) -> bool:
    keys = [str(getattr(p, "key", p)) for p in path]
    return keys[-1] == "bias" and keys[-2] not in NOT_PRE_BN and not keys[-2].startswith("bn")


def _check(key, base, step, skip_pre_bn=False):
    """Per leaf: |port - ref64| <= base(ref64) + 2 |jax32 - ref64|."""
    _, want32, want64, got = step
    ref = [(p, r) for p, r in jax.tree_util.tree_leaves_with_path(want64[key])
           if not (skip_pre_bn and _pre_bn_bias(p))]
    j32 = dict(jax.tree_util.tree_leaves_with_path(want32[key]))
    port = dict(jax.tree_util.tree_leaves_with_path(got[key]))
    assert len(j32) == len(port) >= len(ref) > 0
    for path, r in ref:
        err = np.abs(port[path] - r).max()
        tol = base(r) + 2 * np.abs(j32[path] - r).max()
        assert err <= tol, f"{key}{jax.tree_util.keystr(path)}: |port - f64| {err:.3g} > {tol:.3g}"


def test_train_step_loss_and_logits_match_jax(step):
    _, want32, want64, got = step
    tol = 1e-5 * abs(want64["loss"]) + 2 * abs(want32["loss"] - want64["loss"])
    assert abs(got["loss"] - want64["loss"]) <= tol
    _check("logits", lambda r: 2e-4, step)


def test_train_step_gradients_match_jax(step):
    _check("grads", lambda r: 2e-4 * np.abs(r).max() + 1e-6, step, skip_pre_bn=True)
    # the biases in front of a BatchNorm: exactly zero on both sides but for
    # rounding, below 1e-4 of the same layer's weight gradient
    _, _, want64, got = step
    for source in (got, want64):
        for path, g in jax.tree_util.tree_leaves_with_path(source["grads"]):
            if _pre_bn_bias(path):
                keys = [str(getattr(p, "key", p)) for p in path]
                tree = source["grads"]
                for k in keys[:-1]:
                    tree = tree[k]
                assert np.abs(g).max() <= 1e-4 * np.abs(tree["kernel"]).max(), keys


def test_train_step_batch_stats_match_jax(step):
    _check("batch_stats", lambda r: 1e-5 * np.abs(r).max(), step)
