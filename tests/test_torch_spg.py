"""The PyTorch port's Superpoint Graph (``spg``, ``superpoint_graph``)
against the JAX package, on the CPU.

Indices bit for bit: the k-means assignment and the superpoint graph's
neighbours (both in the expanded distance form, as the JAX line), the
poolings' top-k. Floats within 1e-6 for the statistics (values of order
1) and 2e-4 for modules and logits (PARITY.md §7). The quantile pooling is
held at empty, one-point and two-point superpoints, its values and its
gradient; where values tie (ReLU zeros) JAX's sort is unstable, so the
gradient's point within a tie may differ and each superpoint's sum of it
is held instead. The model's forward and one train-mode step run on the
JAX forward's partition and picks (``JaxPicks``): the step is held in
float64 as tests/test_torch_randlanet_train.py holds RandLA-Net's.
"""

import torch_cpu  # noqa: F401  (first: torch's threads a worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_bridge_tpu.models import get_model as jax_get_model
from pointcloud_bridge_tpu.models import spg as jspg
from pointcloud_bridge_tpu.ops.core import square_distance as jax_square_distance
from pointcloud_bridge_tpu_torch.models import (
    ContextAwareGraphPooling,
    EnhancedGraphConv,
    HierarchicalGraphPooling,
    get_model,
)
from pointcloud_bridge_tpu_torch.models import spg as tspg
from pointcloud_bridge_tpu_torch.utils.weights import flax_to_state_dict

from test_torch_bristrunet import module_rules
from test_torch_randlanet import JaxPicks, _cloud, _t, jax_variables
from test_torch_randlanet import test_weights_round_trip_exactly_and_completely as round_trip
from test_torch_randlanet_train import check, check_loss_and_logits, train_steps

TOL = 2e-4
F64 = 1e-9
KW = {"superpoint_size": 8}  # S = 64 superpoints of 512 points
# the partition, then the graph's top-k and the two poolings' (jax.lax.top_k
# in the JAX model; top_k_nodes in the port)
SITES = [(jspg, "kmeans_partition", tspg, "kmeans_partition", None),
         (jax.lax, "top_k", tspg, "top_k_nodes", (1,))]
# and for the float64 step what both packages compute in float32 from the
# coordinates alone, which enters as an input: the superpoints' eigenvalues
# and principal direction (ops/structure.py:78) and the centroids' squared
# distances (ops/core.py:58-80, square_distance(c, c)). Two float32 GEMMs or
# a covariance one float64 rounding apart land a float32 spacing apart,
# which the train-mode BatchNorms amplify to 1e-4 of a gradient.
STEP_SITES = SITES + [(jspg, "eigh3x3", tspg, "eigh3x3", None),
                      (jspg, "min_eigvec3x3", tspg, "min_eigvec3x3", None),
                      (jspg, "square_distance", tspg, "square_distance", None,
                       lambda a, b: a is b)]


def _features(seed, b, n, c, relu=False):
    a = np.random.default_rng(seed).normal(size=(b, n, c)).astype(np.float32)
    return np.maximum(a, 0.0) if relu else a


# ---------------------------------------------------------- partition, stats


def test_kmeans_partition_matches_jax():
    xyz = _cloud(1, 2, 512)
    want = jspg.kmeans_partition(jnp.asarray(xyz), 64, 3)
    got = tspg.kmeans_partition(_t(xyz), 64, 3)
    assert got[0].dtype == torch.int32
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_superpoint_graph_matches_jax_bit_for_bit():
    """The 33 nearest centroids, self included, on the expanded distances;
    equal values to the lower index (``lax.top_k``)."""
    xyz = _cloud(2, 2, 512)
    _, cent, _ = jspg.kmeans_partition(jnp.asarray(xyz), 64, 3)
    _, want = jax.lax.top_k(-jax_square_distance(cent, cent), 33)
    dmat, got = tspg.centroid_graph(_t(cent), 33)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(dmat.numpy(), np.asarray(jax_square_distance(cent, cent)),
                               rtol=0, atol=1e-6)
    assert bool((got[..., :1] == torch.arange(64).view(1, 64, 1)).all())  # self first


def test_top_k_nodes_keeps_the_lower_index_on_ties():
    scores = torch.tensor([[1.0, 3.0, 3.0, 0.5, 3.0]])
    _, want = jax.lax.top_k(jnp.asarray(scores.numpy()), 4)
    np.testing.assert_array_equal(tspg.top_k_nodes(scores, 4).numpy(), np.asarray(want))


def test_segment_stats_match_jax():
    xyz = _cloud(3, 2, 300)
    feats = _features(4, 2, 300, 6)
    assign, _, onehot = jspg.kmeans_partition(jnp.asarray(xyz), 40, 3)
    want = jspg.segment_stats(jnp.asarray(feats), onehot, assign)
    got = tspg.segment_stats(_t(feats), _t(onehot), _t(assign))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


def _edge_partition(b, n, s, seed):
    """An assignment with superpoint 0 and s - 1 empty, 1 of one point, 2 of
    two points and the rest spread over the others -> (assign [B, N] int32,
    onehot [B, N, S] float32)."""
    rng = np.random.default_rng(seed)
    assign = rng.integers(3, s - 1, size=(b, n)).astype(np.int32)
    assign[:, 0] = 1
    assign[:, 1:3] = 2
    assign[:, 3:] = np.where(np.isin(assign[:, 3:], (1, 2)), 3, assign[:, 3:])
    return assign, np.eye(s, dtype=np.float32)[assign]


@pytest.mark.parametrize("relu", [False, True])
def test_quantile_stats_match_jax_at_empty_and_small_segments(relu):
    """[max, mean, std, median, q75] and their gradient (a random cotangent
    through ``jax.vjp``) against the JAX function. Without ties the
    gradient is held element by element; over ReLU outputs (ties at 0)
    each superpoint's sum of it, since JAX's sort may give a tied value's
    cotangent to another point of the tie."""
    b, n, s, c = 2, 200, 12, 5
    assign, onehot = _edge_partition(b, n, s, 5)
    feats = _features(6, b, n, c, relu)
    cts = [np.random.default_rng(7 + i).normal(size=(b, s, c)) for i in range(5)]
    want, vjp = jax.vjp(lambda f: jspg.segment_quantile_stats(f, jnp.asarray(onehot),
                                                              jnp.asarray(assign)),
                        jnp.asarray(feats))
    (want_g,) = vjp(tuple(jnp.asarray(x, jnp.float32) for x in cts))
    ft = _t(feats).requires_grad_(True)
    got = tspg.segment_quantile_stats(ft, _t(onehot), _t(assign))
    torch.autograd.backward(got, [torch.from_numpy(x).float() for x in cts])
    for name, g, w in zip(("max", "mean", "std", "median", "q75"), got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0, atol=1e-6,
                                   err_msg=name)
    g = got[4].detach().numpy()
    assert not g[:, 0].any() and not g[:, s - 1].any()  # empty: 0
    std = got[2].detach().numpy()
    assert not std[:, 1].any() and (std[:, 2] > 0).all()  # one point: 0; two: > 0
    if relu:
        seg = np.eye(s)[assign]  # [B, N, S]
        np.testing.assert_allclose(np.einsum("bns,bnc->bsc", seg, ft.grad.numpy()),
                                   np.einsum("bns,bnc->bsc", seg, np.asarray(want_g)),
                                   rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(ft.grad.numpy(), np.asarray(want_g), rtol=0, atol=1e-5)


def test_quantile_pick_adds_each_cotangent_at_its_point():
    """Median and q75 of a two-point segment are its larger value (index
    min(cnt // 2, cnt - 1) = 1 and min(3 cnt // 4, cnt - 1) = 1): both
    cotangents add at that point."""
    feats = torch.tensor([[[1.0], [5.0], [3.0]]], requires_grad=True)
    assign = torch.tensor([[0, 1, 1]], dtype=torch.int32)
    onehot = torch.nn.functional.one_hot(assign.long(), 2).float()
    _, _, _, med, q75 = tspg.segment_quantile_stats(feats, onehot, assign)
    assert med[0, :, 0].tolist() == [1.0, 5.0] and q75[0, :, 0].tolist() == [1.0, 5.0]
    (2 * med + 3 * q75).sum().backward()
    assert feats.grad[0, :, 0].tolist() == [5.0, 5.0, 0.0]


# ------------------------------------------------------------------ modules


def _load(mod, v):
    mod.load_state_dict(flax_to_state_dict(v, module_rules(mod)), strict=True)
    return mod.eval()


def test_enhanced_graph_conv_matches_jax():
    rng = np.random.default_rng(8)
    x = jnp.asarray(rng.normal(size=(2, 20, 16)).astype(np.float32))
    adj = jnp.asarray((rng.uniform(size=(2, 20, 20)) < 0.3).astype(np.float32))
    adj = adj.at[:, 5].set(0.0)  # an isolated row sends nothing
    ef = jnp.asarray(rng.normal(size=(2, 20, 20, 18)).astype(np.float32))
    jmod = jspg.EnhancedGraphConv(24)
    v = jax_variables(jmod, x, adj, ef)
    want = np.asarray(jmod.apply(v, x, adj, ef))
    got = _load(EnhancedGraphConv(16, 24), v)(_t(x), _t(adj), _t(ef)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_graph_poolings_match_jax():
    rng = np.random.default_rng(9)
    x = jnp.asarray(rng.normal(size=(2, 20, 16)).astype(np.float32))
    adj = jnp.asarray((rng.uniform(size=(2, 20, 20)) < 0.3).astype(np.float32))
    ef = jnp.asarray(rng.normal(size=(2, 20, 20, 18)).astype(np.float32))
    jmod = jspg.HierarchicalGraphPooling(0.5)
    v = jax_variables(jmod, x, adj, ef)
    want = jmod.apply(v, x, adj, ef)
    got = _load(HierarchicalGraphPooling(16, 0.5), v)(_t(x), _t(adj), _t(ef))
    assert got[0].shape == (2, 10, 16)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=TOL, atol=TOL)
    jmod = jspg.ContextAwareGraphPooling(32)
    v = jax_variables(jmod, x, adj)
    want = np.asarray(jmod.apply(v, x, adj))
    got = _load(ContextAwareGraphPooling(16, 32), v)(_t(x), _t(adj)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


# -------------------------------------------------------------------- model


@pytest.fixture(scope="module")
def jax_run():
    """(JAX variables, JAX eval logits recording the picks, the picks,
    the inputs), once for the file: ``superpoint_graph`` names the same
    JAX class as ``spg``."""
    assert type(jax_get_model("superpoint_graph", 5)) is type(jax_get_model("spg", 5))
    mp = pytest.MonkeyPatch()
    try:
        xyz, rgb = jnp.asarray(_cloud(20, 2, 512)), jnp.asarray(_cloud(21, 2, 512))
        jmodel = jax_get_model("spg", 5, **KW)
        v = jax_variables(jmodel, xyz, rgb, train=False)
        picks = JaxPicks(mp, SITES)
        picks.record()
        want = np.asarray(jax.jit(lambda a, b: jmodel.apply(v, a, b, train=False))(xyz, rgb))
        return v, want, picks, (xyz, rgb)
    finally:
        mp.undo()


@pytest.mark.parametrize("name", ["spg", "superpoint_graph"])
def test_eval_logits_match_jax(name, jax_run, monkeypatch):
    """B = 2 x 512 points with colours, 64 superpoints; the port takes the
    JAX forward's partition and top-k picks (one partition and three
    top-k); the picks the port makes itself are held above."""
    v, want, picks, (xyz, rgb) = jax_run
    picks.monkeypatch = monkeypatch
    calls = picks.port_replay()
    model = get_model(name, 5, **KW).eval()
    model.load_state_dict(flax_to_state_dict(v, name), strict=True)
    got = model(_t(xyz), _t(rgb)).detach().numpy()
    assert got.shape == (2, 512, 5)
    assert calls == ["kmeans_partition"] + ["top_k_nodes"] * 3
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_the_port_makes_the_jax_picks_itself(jax_run, monkeypatch):
    """Without the replay the port's own partition and top-k picks are the
    JAX forward's, bit for bit, on these inputs."""
    v, _, picks, (xyz, rgb) = jax_run
    made = []
    real_k, real_t = tspg.kmeans_partition, tspg.top_k_nodes
    monkeypatch.setattr(tspg, "kmeans_partition",
                        lambda *a: made.append(real_k(*a)) or made[-1])
    monkeypatch.setattr(tspg, "top_k_nodes", lambda *a: made.append(real_t(*a)) or made[-1])
    model = get_model("spg", 5, **KW).eval()
    model.load_state_dict(flax_to_state_dict(v, "spg"), strict=True)
    model(_t(xyz), _t(rgb))
    np.testing.assert_array_equal(made[0][0].numpy(), picks.kept[("kmeans_partition", 0)][0])
    for at in range(3):
        np.testing.assert_array_equal(made[1 + at].numpy(), picks.kept[("top_k", at)][1])


def test_axis_name_is_refused():
    """axis_name, refused until the parallel layer was ported, now syncs
    every BatchNorm over that mesh axis."""
    from test_torch_cls_models import all_bns_synced

    assert all_bns_synced(get_model("spg", 5, axis_name="data"), "data")


@pytest.mark.parametrize("name", ["spg", "superpoint_graph"])
def test_weights_round_trip(name):
    round_trip(name)


# ----------------------------------------------------------- one train step


def _step_batch():
    rng = np.random.default_rng(3)
    return {"points": rng.uniform(-1.0, 1.0, size=(2, 512, 3)).astype(np.float32),
            "colors": rng.uniform(size=(2, 512, 3)).astype(np.float32),
            "labels": rng.integers(0, 5, size=(2, 512)).astype(np.int32)}


@pytest.fixture(scope="module")
def step():
    mp = pytest.MonkeyPatch()
    try:
        return train_steps("spg", lambda: get_model("spg", 5, dropout_rate=0.0, **KW),
                           jax_get_model("spg", 5, dropout_rate=0.0, **KW), _step_batch(),
                           STEP_SITES, mp)
    finally:
        mp.undo()


MODULES = ["point_encoder", "sp_encoder", "gconv1", "gbn1", "gpool1", "gconv2", "gbn2",
           "gpool2", "gconv3", "gbn3", "gpooling", "cls_fc1", "cls_bn1", "cls_fc2", "cls_bn2",
           "cls_fc3", "pfp_mlp0", "pfp_mlp1", "pfp_comb0", "pfp_comb1", "pfp_comb2"]


def test_train_loss_and_logits_match_jax(step):
    check_loss_and_logits(step, (2, 512, 5))


@pytest.mark.parametrize("module", MODULES)
def test_train_gradients_match_jax_in_float64(step, module):
    check("grads", module, F64, step[0], step[2])


@pytest.mark.parametrize("module", [m for m in MODULES if "bn" in m or "encoder" in m])
def test_train_batch_stats_match_jax(step, module):
    check("batch_stats", module, 1e-5, step[0], step[1])
    check("batch_stats", module, F64, step[0], step[2])


@pytest.mark.parametrize("module", MODULES)
def test_sgd_step_matches_jax_in_float64(step, module):
    check("sgd_params", module, F64, step[0], step[2])


def test_every_parameter_gets_a_finite_gradient(step):
    """Present and finite in the float32 step, but for the poolings' score
    layers: the scores pick the nodes and do not weigh them
    (models/spg.py:235-252), so no gradient reaches them (JAX's is 0). The
    biases in front of a train-mode BatchNorm (the encoders' Dense,
    gconv*.combine1, cls_fc1 and cls_fc2) and those of the last score layer
    of each softmax (``attn1``: a shift of every score alike) are exactly 0
    in float64."""
    grads, grads64 = step[1]["torch_grads"], step[2]["torch_grads"]
    unscored = {k for k in grads if k.startswith(("gpool1.score", "gpool2.score"))}
    assert len(unscored) == 12 and all(grads[k] is None for k in unscored)
    for k in unscored:
        assert not step[0]["grads"][k.split(".")[0]][k.split(".")[1]][
            "kernel" if k.endswith("weight") else "bias"].any(), k
    zero = {k for k, g in grads64.items() if k.endswith(".bias") and g is not None
            and g.abs().max() <= 1e-12}
    assert zero == ({f"point_encoder.dense_{i}.bias" for i in range(4)}
                    | {f"sp_encoder.dense_{i}.bias" for i in range(3)}
                    | {f"gconv{i}.combine1.bias" for i in (1, 2, 3)}
                    | {f"gconv{i}.attn1.bias" for i in (1, 2, 3)}
                    | {"gpooling.attn1.bias", "cls_fc1.bias", "cls_fc2.bias"})
    for key, g in grads.items():
        if key in unscored:
            continue
        assert g is not None and torch.isfinite(g).all(), key
        if key not in zero:
            assert g.abs().max() > 0, key
