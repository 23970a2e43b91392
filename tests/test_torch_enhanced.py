"""The PyTorch port's ``enhanced_pointnet2_ssg`` and its modules against the
JAX package, on the CPU.

``min_eigvec3x3`` and ``estimate_normals`` (ops/structure.py); the
EnhancedPositionalEncoding's 22-dim structure vector, read where it enters
``struct_mlp0`` (an identity there), per feature within 2e-4 of that
feature's largest value (the density reaches the thousands on tight
neighbourhoods); EnhancedAttentionModule alone in train mode with the JAX
attribute ``dropout=0.0`` (output, statistics, gradients); the model's eval
logits with ``use_attention`` off and on within 2e-4; one train-mode step
of the model with ``use_attention`` off held to the JAX float32 and float64
steps as tests/test_torch_pointnet.py holds PointNet's; the weight round
trips of both configurations. Weights come from a seeded port model
through ``state_dict_to_flax`` (the JAX init is traced once, by
``jax.eval_shape``, to hold the tree).
"""

import torch_cpu  # noqa: F401  (first: torch's threads a worker)

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_bridge_tpu import losses as JL
from pointcloud_bridge_tpu.models import get_model as jax_get_model
from pointcloud_bridge_tpu.models.attention import EnhancedAttentionModule as JEAM
from pointcloud_bridge_tpu.models.attention import EnhancedPositionalEncoding as JEPE
from pointcloud_bridge_tpu.ops.structure import estimate_normals as j_estimate_normals
from pointcloud_bridge_tpu.ops.structure import min_eigvec3x3 as j_min_eigvec3x3
from pointcloud_bridge_tpu_torch import losses
from pointcloud_bridge_tpu_torch.models import get_model
from pointcloud_bridge_tpu_torch.models.attention import (
    EnhancedAttentionModule,
    EnhancedPositionalEncoding,
)
from pointcloud_bridge_tpu_torch.ops import estimate_normals, min_eigvec3x3
from pointcloud_bridge_tpu_torch.utils.weights import (
    _by_flax_path,
    _dense_bn,
    enhanced_pointnet2_ssg_rules,
    flax_to_state_dict,
    state_dict_to_flax,
)

from test_torch_bristrunet import randomize
from test_torch_ssg import randomize_bn

SA = (64, 32, 16)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_min_eigvec3x3_matches_jax():
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(500, 20, 3)) * np.array([1.0, 0.5, 0.05])
    cov = np.einsum("nki,nkj->nij", pts, pts).astype(np.float32)
    cov[:3] = np.eye(3, dtype=np.float32) * 2.0  # degenerate: the +z fallback
    want = np.asarray(j_min_eigvec3x3(jnp.asarray(cov)))
    got = min_eigvec3x3(_t(cov)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(got[:3], np.tile([0.0, 0.0, 1.0], (3, 1)))


def test_estimate_normals_matches_jax():
    rng = np.random.default_rng(2)
    xyz = rng.uniform(size=(2, 256, 3)).astype(np.float32)
    xyz[..., 2] *= 0.05  # near-planar patches: well separated normals
    want = np.asarray(j_estimate_normals(jnp.asarray(xyz), k=20))
    got = estimate_normals(_t(xyz), k=20).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_structure_vector_matches_jax():
    """The 22 features where they enter ``struct_mlp0`` (identity weights,
    no bias, channels 44: half 22), on a cloud with tight neighbourhoods.
    The tight patch sits at the origin: the JAX k-NN ranks by the expanded
    form |a|^2 + |b|^2 - 2ab, which cancels to noise at spacings of 1e-3
    a unit away and would pick other neighbours than the direct form."""
    rng = np.random.default_rng(3)
    xyz = np.concatenate([rng.uniform(size=(2, 200, 3)),
                          1e-3 * rng.normal(size=(2, 56, 3))], axis=1).astype(np.float32)
    jm = JEPE(channels=44)
    variables = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                                           jnp.asarray(xyz)))
    variables["params"]["struct_mlp0"] = {"kernel": np.eye(22, dtype=np.float32),
                                         "bias": np.zeros(22, np.float32)}
    _, inter = jm.apply(variables, jnp.asarray(xyz), capture_intermediates=True)
    want = np.asarray(inter["intermediates"]["struct_mlp0"]["__call__"][0])
    port = EnhancedPositionalEncoding(44).eval()
    port.load_state_dict(flax_to_state_dict(variables, _by_flax_path(_dense_bn(
        (), ("rel_mlp0", "rel_bn", "rel_mlp1", "struct_mlp0", "struct_bn", "struct_mlp1")))))
    seen = []
    port.struct_mlp0.register_forward_hook(lambda m, i, o: seen.append(o))
    with torch.no_grad():
        out = port(_t(xyz))
    got = seen[0].numpy()
    assert got.shape == want.shape == (2, 256, 22)
    assert want[..., 13].max() > 1000  # the density of the tight patch
    scale = np.abs(want).reshape(-1, 22).max(0)
    np.testing.assert_array_less(np.abs(got - want).reshape(-1, 22).max(0), 2e-4 * scale + 1e-7)
    full = np.asarray(jm.apply(variables, jnp.asarray(xyz)))
    np.testing.assert_allclose(out.numpy(), full, rtol=2e-4, atol=2e-4 * np.abs(full).max())


def test_attention_module_train_mode_without_dropout_matches_jax():
    """The output, the input's gradient and the statistics against the JAX
    module in float32; the parameters' gradients against it in float64,
    with the same tolerance. ``sa0``'s bias feeds a train-mode BatchNorm,
    so its gradient is exactly zero (within 1e-15 in float64) and both
    float32 gradients are rounding noise of up to 9e-7: against each other
    they would compare noise with noise."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 64, 32)).astype(np.float32)
    g = rng.normal(size=(2, 64, 32)).astype(np.float32)
    jm = JEAM(dropout=0.0)
    variables = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))

    def loss(params, stats, xx, gg):
        out, mut = jm.apply({"params": params, "batch_stats": stats}, xx,
                            train=True, mutable=["batch_stats"])
        return jnp.sum(out * gg), (out, mut["batch_stats"])

    grad = jax.value_and_grad(loss, argnums=(0, 2), has_aux=True)
    (_, (want, stats)), (_, dx) = jax.jit(grad)(
        variables["params"], variables["batch_stats"], jnp.asarray(x), jnp.asarray(g))
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        _, (dparams, _) = jax.jit(grad)(v64["params"], v64["batch_stats"],
                                        x.astype(np.float64), g.astype(np.float64))
        dparams = jax.tree_util.tree_map(np.asarray, dparams)
    finally:
        jax.config.update("jax_enable_x64", x64)
    rules = _by_flax_path(_dense_bn((), ("ca0", "ca1", "sa0", "sa_bn", "sa1")))
    port = EnhancedAttentionModule(32, dropout=0.0)
    port.load_state_dict(flax_to_state_dict(variables, rules), strict=True)
    tx = _t(x).requires_grad_(True)
    out = port.train()(tx)
    (out * _t(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(dx), rtol=2e-4, atol=2e-4)
    got = state_dict_to_flax({k: p.grad for k, p in port.named_parameters()}, rules)["params"]
    for path, leaf in jax.tree_util.tree_leaves_with_path(dparams):
        port_leaf = dict(jax.tree_util.tree_leaves_with_path(got))[path]
        np.testing.assert_allclose(port_leaf, np.asarray(leaf), rtol=2e-4,
                                   atol=2e-4 * np.abs(np.asarray(leaf)).max() + 1e-6)
    port_stats = state_dict_to_flax(port.state_dict(), rules)["batch_stats"]["sa_bn"]
    for key in ("mean", "var"):
        np.testing.assert_allclose(port_stats[key], np.asarray(stats["sa_bn"][key]), rtol=1e-5,
                                   atol=1e-6)


def model_inputs(seed=11, b=2, n=256):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(b, n, 3)).astype(np.float32),
            rng.uniform(size=(b, n, 3)).astype(np.float32))


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "attention"])
def case(request):
    attn = request.param
    xyz, feats = model_inputs()
    seeded = get_model("enhanced_pointnet2_ssg", 5, use_attention=attn, sa_npoints=SA,
                       generator=torch.Generator().manual_seed(0))
    rules = enhanced_pointnet2_ssg_rules(attn)
    variables = randomize_bn(state_dict_to_flax(seeded.state_dict(), rules))
    jmodel = jax_get_model("enhanced_pointnet2_ssg", 5, use_attention=attn, sa_npoints=SA)
    want = np.asarray(jax.jit(lambda v, a, b: jmodel.apply(v, a, b, train=False))(
        variables, jnp.asarray(xyz), jnp.asarray(feats)))
    return attn, rules, variables, xyz, feats, want


def test_eval_logits_match_jax(case):
    attn, rules, variables, xyz, feats, want = case
    model = get_model("enhanced_pointnet2_ssg", 5, use_attention=attn, sa_npoints=SA)
    model.load_state_dict(flax_to_state_dict(variables, rules), strict=True)
    with torch.no_grad():
        got = model.eval()(_t(xyz), _t(feats))
    assert got.shape == want.shape == (2, 256, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_weights_round_trip_exactly_and_completely(case):
    attn, rules, variables, xyz, feats, _ = case
    tree = jax.eval_shape(lambda: jax_get_model(
        "enhanced_pointnet2_ssg", 5, use_attention=attn, sa_npoints=SA).init(
        jax.random.PRNGKey(0), jnp.asarray(xyz), jnp.asarray(feats), train=False))
    assert ({jax.tree_util.keystr(p): leaf.shape
             for p, leaf in jax.tree_util.tree_leaves_with_path(tree)}
            == {jax.tree_util.keystr(p): np.shape(leaf)
                for p, leaf in jax.tree_util.tree_leaves_with_path(variables)})
    sd = flax_to_state_dict(variables, rules)
    model = get_model("enhanced_pointnet2_ssg", 5, use_attention=attn, sa_npoints=SA)
    assert set(sd) == set(model.state_dict())
    got = dict(jax.tree_util.tree_leaves_with_path(state_dict_to_flax(sd, rules)))
    for path, leaf in jax.tree_util.tree_leaves_with_path(variables):
        np.testing.assert_array_equal(got[path], np.asarray(leaf))


# ------------------------------------------------------------ train step


def _jax_step(variables, b, dtype):
    jmodel = jax_get_model("enhanced_pointnet2_ssg", 5, sa_npoints=SA)
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), variables)
    x, f = np.asarray(b["points"], dtype), np.asarray(b["colors"], dtype)

    # the batch goes in as arguments: as constants of the traced step, XLA
    # would fold the k-NN's sort over them at compile time (seconds)
    def loss_fn(params, stats, x, f, labels, cw):
        logits, mut = jmodel.apply({"params": params, "batch_stats": stats}, x, f, train=True,
                                   mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
        return JL.weighted_cross_entropy(logits, labels, cw), (logits, mut["batch_stats"])

    def no_dropout(next_fun, args, kwargs, context):
        # the JAX model fixes its head's dropout rate: its Dropout is the
        # identity here, as the port's head at p = 0
        if isinstance(context.module, nn.Dropout) and context.method_name == "__call__":
            return args[0]
        return next_fun(*args, **kwargs)

    def step_fn(*args):
        with nn.intercept_methods(no_dropout):
            return jax.value_and_grad(loss_fn, has_aux=True)(*args)

    (loss, (logits, stats)), grads = jax.jit(step_fn)(
        v["params"], v["batch_stats"], x, f, b["labels"], np.asarray(b["cw"], dtype))
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), {
        "loss": loss, "logits": logits, "grads": grads, "batch_stats": stats})


@pytest.fixture(scope="module")
def step():
    """One train step without dropout on either side: the port's head at
    p = 0, the JAX head's Dropout intercepted as the identity (the JAX
    model gives no way to set its rate)."""
    rng = np.random.default_rng(4)
    xyz, feats = model_inputs(seed=6, b=2, n=256)
    b = {"points": xyz, "colors": feats,
         "labels": rng.integers(0, 5, size=(2, 256)).astype(np.int32),
         "cw": (0.5 + rng.uniform(size=5)).astype(np.float32)}
    seeded = get_model("enhanced_pointnet2_ssg", 5, sa_npoints=SA,
                       generator=torch.Generator().manual_seed(0))
    variables = randomize(state_dict_to_flax(seeded.state_dict(), "enhanced_pointnet2_ssg"))
    want32 = _jax_step(variables, b, np.float32)
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        want64 = _jax_step(variables, b, np.float64)
    finally:
        jax.config.update("jax_enable_x64", x64)
    model = get_model("enhanced_pointnet2_ssg", 5, sa_npoints=SA)
    model.load_state_dict(flax_to_state_dict(variables, "enhanced_pointnet2_ssg"), strict=True)
    model.drop1.p = 0.0
    logits = model.train()(_t(xyz), _t(feats))
    loss = losses.weighted_cross_entropy(logits, _t(b["labels"]).long(), _t(b["cw"]))
    loss.backward()
    to64 = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), t)  # noqa: E731
    grads = {k: p.grad for k, p in model.named_parameters()}
    return want32, want64, {
        "loss": float(loss.detach()), "logits": logits.detach().double().numpy(),
        "grads": to64(state_dict_to_flax(grads, "enhanced_pointnet2_ssg")["params"]),
        "batch_stats": to64(state_dict_to_flax(model.state_dict(),
                                               "enhanced_pointnet2_ssg")["batch_stats"]),
    }


def _pre_bn_bias(path) -> bool:
    """A bias in front of a train-mode BatchNorm: every Dense but the
    head's last and the encoding's rel_mlp1 and struct_mlp1."""
    keys = [str(getattr(p, "key", p)) for p in path]
    return (keys[-1] == "bias" and not keys[-2].startswith("bn")
            and keys[-2] not in ("dense1", "rel_mlp1", "struct_mlp1"))


def _check(key, base, step, skip_pre_bn=False):
    want32, want64, got = step
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
    want32, want64, got = step
    tol = 1e-5 * abs(want64["loss"]) + 2 * abs(want32["loss"] - want64["loss"])
    assert abs(got["loss"] - want64["loss"]) <= tol
    _check("logits", lambda r: 2e-4, step)


def test_train_step_gradients_match_jax(step):
    _check("grads", lambda r: 2e-4 * np.abs(r).max() + 1e-6, step, skip_pre_bn=True)


def test_train_step_batch_stats_match_jax(step):
    _check("batch_stats", lambda r: 1e-5 * np.abs(r).max(), step)
