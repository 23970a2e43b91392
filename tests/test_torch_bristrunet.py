"""The PyTorch port's BriStruNet and its building blocks against the JAX
package, on the CPU.

Every flax module is initialised from a seed, its parameters are perturbed
and its BatchNorms moved away from the identity in numpy (fresh biases are
zero and a fresh BatchNorm is the identity, which would hide a mapping
error), and the variables are converted with the port's utils/weights.py
and loaded with strict=True. Eval outputs agree to 2e-4 (PARITY.md §7's
band for torch-vs-JAX parity).
"""

import torch_cpu  # noqa: F401  (first: torch's threads a worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_bridge_tpu.models import attention as jattn
from pointcloud_bridge_tpu.models import common as jcommon
from pointcloud_bridge_tpu.models import get_model as jax_get_model
from pointcloud_bridge_tpu_torch.models import (
    BatchNorm,
    BriStruNet,
    BridgeStructureEncoding,
    ColorFeatureExtraction,
    CompositeFeatureFusion,
    Dense,
    EnhancedFeaturePropagation,
    GeometricFeatureExtraction,
    MultiScaleFeatureFusion,
    MultiScaleSetAbstraction,
    get_model,
)
from pointcloud_bridge_tpu_torch.models.attention import resize_nearest
from pointcloud_bridge_tpu_torch.utils.weights import (
    bristrunet_rules,
    flax_to_state_dict,
    state_dict_to_flax,
)

TOL = 2e-4
SA_NPOINTS = (48, 24, 12)  # the size tests/test_model_zoo.py uses


def _t(a):
    return torch.from_numpy(np.array(a))


def randomize(variables, seed=0):
    """Numpy copy of flax variables with every parameter perturbed and
    every BatchNorm statistic away from the identity."""
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.02 * rng.normal(size=a.shape)).astype(np.float32),
        variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, variables.get("batch_stats", {}))

    def walk(s):
        for key in s:
            if "mean" in s[key]:
                c = s[key]["mean"].shape
                s[key] = {"mean": (0.1 * rng.normal(size=c)).astype(np.float32),
                          "var": (0.5 + rng.uniform(size=c)).astype(np.float32)}
            else:
                walk(s[key])

    walk(stats)
    return {"params": params, "batch_stats": stats}


def module_rules(module):
    """Rules of a port module whose layer names are the flax names."""
    rules = []
    for name, m in module.named_modules():
        if isinstance(m, (Dense, BatchNorm)):
            rules.append((name, tuple(name.split(".")), "bn" if isinstance(m, BatchNorm) else "dense"))
    return rules


def run_both(jmodule, tmodule, *arrays):
    """Init the flax module on ``arrays``, randomise, load the converted
    weights into the port module, and return (port output, JAX output)."""
    jargs = [None if a is None else jnp.asarray(a) for a in arrays]
    variables = randomize(
        jax.jit(lambda *a: jmodule.init(jax.random.PRNGKey(0), *a, train=False))(*jargs))
    want = jax.jit(lambda v, *a: jmodule.apply(v, *a, train=False))(variables, *jargs)
    tmodule.load_state_dict(flax_to_state_dict(variables, module_rules(tmodule)), strict=True)
    tmodule.eval()
    with torch.inference_mode():
        got = tmodule(*[None if a is None else _t(a) for a in arrays])
    return got, want


def assert_close(got, want):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    assert np.abs(want).max() > 1e-2  # not a dead output
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_multi_scale_set_abstraction_matches_jax(rng):
    xyz = rng.uniform(size=(2, 128, 3)).astype(np.float32)
    feats = rng.normal(size=(2, 128, 5)).astype(np.float32)
    jm = jcommon.MultiScaleSetAbstraction(32, (0.2, 0.4), (8, 16), (16, 16, 32))
    tm = MultiScaleSetAbstraction(32, (0.2, 0.4), (8, 16), 3 + 5, (16, 16, 32))
    (new_xyz, out), (want_xyz, want) = run_both(jm, tm, xyz, feats)
    np.testing.assert_array_equal(new_xyz.numpy(), np.asarray(want_xyz))
    assert out.shape == (2, 32, 64)
    assert_close(out, want)


@pytest.mark.parametrize("mlp", [(24, 24), (32, 16)], ids=["residual", "plain"])
def test_enhanced_feature_propagation_matches_jax(rng, mlp):
    fine = rng.uniform(size=(2, 64, 3)).astype(np.float32)
    coarse = fine[:, :16]
    f_fine = rng.normal(size=(2, 64, 8)).astype(np.float32)
    f_coarse = rng.normal(size=(2, 16, 16)).astype(np.float32)
    jm = jcommon.EnhancedFeaturePropagation(mlp)
    tm = EnhancedFeaturePropagation(8 + 16, mlp)
    assert tm.residual == (mlp[-1] == 24)
    got, want = run_both(jm, tm, fine, coarse, f_fine, f_coarse)
    assert_close(got, want)


def test_enhanced_feature_propagation_without_skip_matches_jax(rng):
    fine = rng.uniform(size=(2, 64, 3)).astype(np.float32)
    f_coarse = rng.normal(size=(2, 16, 16)).astype(np.float32)
    got, want = run_both(jcommon.EnhancedFeaturePropagation((16, 8)),
                         EnhancedFeaturePropagation(16, (16, 8)),
                         fine, fine[:, :16], None, f_coarse)
    assert_close(got, want)


@pytest.mark.parametrize("channels,k,bands", [(3, 32, 4), (16, 16, 4), (8, 8, 2)])
def test_bridge_structure_encoding_matches_jax(rng, channels, k, bands):
    # coordinates across several unit grid cells, negative ones included
    xyz = rng.uniform(-2.5, 2.5, size=(2, 64, 3)).astype(np.float32)
    jm = jattn.BridgeStructureEncoding(channels, k, bands)
    tm = BridgeStructureEncoding(channels, k, bands)
    assert tm.mlp0_shared.bias is None and tm.mlp0_shared.weight.shape == (channels, 6 * bands + 13)
    got, want = run_both(jm, tm, xyz)
    assert_close(got, want)


def test_bridge_structure_encoding_caps_k_at_n(rng):
    xyz = rng.uniform(size=(2, 12, 3)).astype(np.float32)
    got, want = run_both(jattn.BridgeStructureEncoding(8, 16), BridgeStructureEncoding(8, 16), xyz)
    assert_close(got, want)


def test_color_feature_extraction_matches_jax(rng):
    colors = rng.uniform(size=(2, 64, 3)).astype(np.float32)
    got, want = run_both(jattn.ColorFeatureExtraction(6), ColorFeatureExtraction(6, 3), colors)
    assert_close(got, want)


def test_composite_feature_fusion_matches_jax(rng):
    spatial = rng.normal(size=(2, 64, 3)).astype(np.float32)
    color = rng.normal(size=(2, 64, 6)).astype(np.float32)
    got, want = run_both(jattn.CompositeFeatureFusion(3), CompositeFeatureFusion(9, 3),
                         spatial, color)
    assert_close(got, want)


def test_geometric_feature_extraction_matches_jax(rng):
    x = rng.normal(size=(2, 48, 12)).astype(np.float32)
    xyz = rng.uniform(-1.5, 1.5, size=(2, 48, 3)).astype(np.float32)
    tm = GeometricFeatureExtraction(12)
    assert tm.br_pos.k_neighbors == 16 and tm.br_pos.freq_bands == 4
    got, want = run_both(jattn.GeometricFeatureExtraction(), tm, x, xyz)
    assert_close(got, want)


def test_multi_scale_feature_fusion_matches_jax(rng):
    feats = [rng.normal(size=(2, m, c)).astype(np.float32)
             for m, c in ((12, 8), (24, 8), (128, 4))]
    jm = jattn.MultiScaleFeatureFusion(16)
    tm = MultiScaleFeatureFusion((8, 8, 4), 16)
    variables = randomize(jm.init(jax.random.PRNGKey(0), [jnp.asarray(f) for f in feats], train=False))
    want = jm.apply(variables, [jnp.asarray(f) for f in feats], train=False)
    tm.load_state_dict(flax_to_state_dict(variables, module_rules(tm)), strict=True)
    tm.eval()
    with torch.inference_mode():
        got = tm([_t(f) for f in feats])
    assert got.shape == (2, 128, 48)
    assert_close(got, want)


@pytest.mark.parametrize("m,n", [(24, 128), (12, 128), (512, 4096), (128, 4096), (128, 48), (7, 7)])
def test_resize_nearest_reads_the_rows_jax_reads(m, n):
    """jax.image.resize(method='nearest') reads row floor((i + 0.5) * m / n);
    F.interpolate(mode='nearest') reads floor(i * m / n), other rows."""
    feat = np.arange(m, dtype=np.float32).reshape(1, m, 1) * np.ones((2, 1, 3), np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(feat), (2, n, 3), method="nearest"))
    got = resize_nearest(_t(feat), n)
    np.testing.assert_array_equal(got.numpy(), want)
    if n % m:  # at a whole ratio the two rules read the same rows
        legacy = torch.nn.functional.interpolate(
            _t(feat).transpose(1, 2), size=n, mode="nearest").transpose(1, 2)
        assert not torch.equal(legacy, got)


# ------------------------------------------------------------ the whole model


@pytest.fixture(scope="module")
def bristrunet():
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-1.0, 1.0, size=(2, 128, 3)).astype(np.float32)
    rgb = rng.uniform(size=(2, 128, 3)).astype(np.float32)
    jmodel = jax_get_model("bristrunet", 5, sa_npoints=SA_NPOINTS)
    variables = randomize(jax.jit(
        lambda a, b: jmodel.init(jax.random.PRNGKey(0), a, b, train=False)
    )(jnp.asarray(xyz), jnp.asarray(rgb)))
    want = np.asarray(jax.jit(lambda v, a, b: jmodel.apply(v, a, b, train=False))(
        variables, jnp.asarray(xyz), jnp.asarray(rgb)))
    model = get_model("bristrunet", 5, sa_npoints=SA_NPOINTS)
    model.load_state_dict(flax_to_state_dict(variables, "bristrunet"), strict=True)
    model.eval()
    with torch.inference_mode():
        got = model(_t(xyz), _t(rgb))
    return variables, model, got, want, (xyz, rgb)


def test_bristrunet_logits_match_jax(bristrunet):
    _, _, got, want, _ = bristrunet
    assert got.shape == (2, 128, 5) and got.dtype == torch.float32
    assert want.std(axis=1).min() > 1e-3  # the logits vary over the points
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got.argmax(-1).numpy(), want.argmax(-1))


def test_bristrunet_features_default_to_xyz(bristrunet):
    variables, model, _, _, (xyz, _) = bristrunet
    jmodel = jax_get_model("bristrunet", 5, sa_npoints=SA_NPOINTS)
    want = np.asarray(jax.jit(lambda v, a: jmodel.apply(v, a, None, train=False))(
        variables, jnp.asarray(xyz)))
    with torch.inference_mode():
        got = model(_t(xyz), None)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_bristrunet_weights_round_trip_is_exact_and_complete(bristrunet):
    """flax -> state_dict -> flax gives every leaf back bit for bit, and the
    rule table covers every flax leaf and every entry of the state_dict."""
    variables, model, _, _, _ = bristrunet
    back = state_dict_to_flax(model.state_dict(), "bristrunet")

    def leaves(tree):
        return {jax.tree_util.keystr(k): np.asarray(v)
                for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

    want, got = leaves(variables), leaves(back)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    sd = flax_to_state_dict(variables, "bristrunet")
    assert set(sd) == set(model.state_dict())
    prefixes = [r[0] for r in bristrunet_rules()]
    assert len(prefixes) == len(set(prefixes))
    assert sorted(prefixes) == sorted(r[0] for r in module_rules(model))


@pytest.mark.parametrize("name", ["bristrunet", "enhanced_pointnet2", "bridgeseg"])
def test_registry_names_build_bristrunet(name):
    model = get_model(name, 5, sa_npoints=SA_NPOINTS, generator=torch.Generator().manual_seed(0))
    assert isinstance(model, BriStruNet)
    assert model.bri_enc.k_neighbors == 32 and model.bri_enc.freq_bands == 4
    assert model.bri_enc.mlp1.weight.shape == (3, 3)
    other = get_model(name, 5, sa_npoints=SA_NPOINTS, generator=torch.Generator().manual_seed(0))
    for (k, a), b in zip(model.state_dict().items(), other.state_dict().values()):
        assert torch.equal(a, b), k


def test_unknown_model_is_a_value_error():
    with pytest.raises(ValueError, match="unknown model"):
        get_model("no_such_model", 5)
    with pytest.raises(KeyError, match="no weight rules"):
        flax_to_state_dict({"params": {}, "batch_stats": {}}, "no_such_model")


def test_bristrunet_train_mode_forward_and_backward(rng):
    """Train mode runs on the CPU: finite logits, BatchNorm statistics move,
    every parameter gets a finite gradient (BriStruNet training on the card
    is a later slice; this holds the autograd graph together)."""
    model = get_model("bristrunet", 5, sa_npoints=SA_NPOINTS,
                      generator=torch.Generator().manual_seed(0), dropout_rate=0.0)
    model.train()
    xyz = _t(rng.uniform(-1.0, 1.0, size=(2, 128, 3)).astype(np.float32))
    rgb = _t(rng.uniform(size=(2, 128, 3)).astype(np.float32))
    before = model.final_bn.running_mean.clone()
    logits = model(xyz, rgb)
    assert torch.isfinite(logits).all()
    assert not torch.equal(model.final_bn.running_mean, before)
    logits.square().mean().backward()
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
