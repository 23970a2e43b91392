"""The PyTorch port's DGCNN and DGCNNGlobal against the JAX package, on the
CPU: ``edge_conv_graph_feature``, each EdgeConv, both models' eval logits,
their k-NN graphs stage by stage, and the weight round trip of both rule
tables.

Weights: every flax module is initialised from a seed, every parameter
perturbed and every BatchNorm moved away from the identity in numpy
(tests/test_torch_bristrunet.py ``randomize``), converted with the port's
utils/weights.py and loaded with strict=True. Outputs agree to 2e-4
(PARITY.md §7's band for torch-vs-JAX parity).

Graphs. Each EdgeConv builds its k-NN graph from features that came
through GEMMs, which the two packages round differently; the JAX package
measures distances in the expanded form and the port in the direct one
(tests/test_torch_knn.py). A near tie at the k-th neighbour may therefore
swap, and a swapped pick moves that point's max by O(1). So the whole-model
checks hand the JAX package's graphs to the port: the JAX ``knn`` is
wrapped to record each stage's input and graph, and the port's ``knn`` is
replaced by one that returns them. Separately, every stage's graph is held
against the port's own ``knn`` on the same recorded input with the tie band
of tests/test_torch_knn_channels.py: identical indices wherever the JAX
distances of the two picks differ by more than 1e-6 of the row's largest.
"""

import torch_cpu  # noqa: F401  (first: torch's threads a worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_bridge_tpu.models import dgcnn as jdgcnn
from pointcloud_bridge_tpu.models import get_model as jax_get_model
from pointcloud_bridge_tpu.ops import edge_conv_graph_feature as jax_graph_feature
from pointcloud_bridge_tpu.ops import knn as jax_knn
from pointcloud_bridge_tpu.ops import square_distance
from pointcloud_bridge_tpu_torch import ops
from pointcloud_bridge_tpu_torch.models import BatchNorm, DGCNN, DGCNNGlobal, EdgeConv, get_model
from pointcloud_bridge_tpu_torch.models import dgcnn as tdgcnn
from pointcloud_bridge_tpu_torch.utils.weights import (
    MODEL_RULES,
    flax_to_state_dict,
    state_dict_to_flax,
)

from test_torch_bristrunet import randomize
from test_torch_knn_channels import assert_same_neighbours

TOL = 2e-4
B, N = 2, 128
MODELS = {"dgcnn": DGCNN, "dgcnn_global": DGCNNGlobal}


def _t(a):
    return torch.from_numpy(np.array(a))


def cloud(seed: int, n: int = N) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-1.0, 1.0, size=(B, n, 3)).astype(np.float32)


def jax_variables(name: str, xyz: np.ndarray, seed: int, **kwargs) -> dict:
    """Seeded flax variables of the JAX model, perturbed (numpy)."""
    jmodel = jax_get_model(name, 5, **kwargs)
    v = jax.jit(lambda x: jmodel.init(jax.random.PRNGKey(seed), x, None, train=False))(xyz)
    return randomize(v, seed)


class JaxGraphs:
    """Wraps the JAX model's ``knn`` and ``knn_set``
    (pointcloud_bridge_tpu.models.dgcnn: the literal EdgeConv calls the
    first, the restructured one the second) so that each stage's input
    features and graph are recorded, in order, also inside jit and under
    grad (a debug callback on the primal values); or, once recorded,
    replays them instead of searching (``replay``)."""

    SEARCHES = ("knn", "knn_set")

    def __init__(self, monkeypatch):
        self.monkeypatch = monkeypatch
        self.stages = {}

    def record(self):
        calls = []

        def recording(real):
            def search(x, query=None, k=20, *args, **kwargs):
                idx = real(x, query, k, *args, **kwargs)
                stage = len(calls)
                calls.append(stage)
                jax.debug.callback(
                    lambda xv, iv, stage=stage: self.stages.__setitem__(
                        stage, (np.asarray(xv, np.float32), np.asarray(iv))), x, idx)
                return idx
            return search

        self.stages.clear()
        for name in self.SEARCHES:
            self.monkeypatch.setattr(jdgcnn, name, recording(getattr(jdgcnn, name)))

    def replay(self):
        graphs, calls = self.graphs(), []

        def replaying(x, query=None, k=20, *args, **kwargs):
            calls.append(None)
            idx = graphs[len(calls) - 1]
            assert idx.shape == x.shape[:2] + (k,)
            return jnp.asarray(idx)

        for name in self.SEARCHES:
            self.monkeypatch.setattr(jdgcnn, name, replaying)

    def graphs(self) -> list:
        assert sorted(self.stages) == [0, 1, 2, 3], sorted(self.stages)
        return [self.stages[i][1] for i in range(4)]

    def port_replay(self):
        """The port's EdgeConvs take the recorded graphs, in order, in
        either form."""
        graphs, calls = self.graphs(), []

        def replaying(x, query=None, k=20):
            idx = graphs[len(calls)]
            calls.append(None)
            assert idx.shape == tuple(x.shape[:2]) + (k,)
            return torch.from_numpy(idx.copy())

        for name in self.SEARCHES:
            self.monkeypatch.setattr(tdgcnn, name, replaying)
        return calls


def assert_graphs_within_the_tie_band(stages: dict) -> int:
    """Every recorded stage: the port's knn on the JAX stage input against
    the JAX graph, within the tie band -> the number of picks that differ."""
    differ = 0
    for stage in range(4):
        x, want = stages[stage]
        got = ops.knn(_t(x), k=want.shape[-1]).numpy()
        full = np.asarray(square_distance(jnp.asarray(x), jnp.asarray(x)))
        assert_same_neighbours(got, want, full)
        differ += int((got != want).sum())
    return differ


# ----------------------------------------------------------------- the op


@pytest.mark.parametrize("c,k", [(3, 20), (64, 20), (64, N - 1), (5, 7)])
def test_edge_conv_graph_feature_matches_jax(c, k):
    """(x_j - x_i, x_i) over a given graph: the same bits; over the port's
    own graph on an integer grid (no near ties: both forms exact), the
    same bits as the JAX op's own graph."""
    rng = np.random.default_rng(c + k)
    x = rng.normal(size=(B, N, c)).astype(np.float32)
    idx = np.asarray(jax_knn(jnp.asarray(x), k=k))
    want = np.asarray(jax_graph_feature(jnp.asarray(x), k=k, idx=jnp.asarray(idx)))
    got = ops.edge_conv_graph_feature(_t(x), k=k, idx=_t(idx))
    assert got.shape == (B, N, k, 2 * c)
    np.testing.assert_array_equal(got.numpy(), want)
    grid = rng.integers(0, 3, (B, N, c)).astype(np.float32)
    np.testing.assert_array_equal(ops.edge_conv_graph_feature(_t(grid), k=k).numpy(),
                                  np.asarray(jax_graph_feature(jnp.asarray(grid), k=k)))


def test_edge_conv_graph_feature_is_differentiable():
    """The gather's backward: each point gets its neighbours' centre-relative
    gradients back, and its own centre channels."""
    x = torch.rand(1, 16, 4, requires_grad=True)
    idx = ops.knn(x, k=5)
    g = ops.edge_conv_graph_feature(x, idx=idx)
    g.sum().backward()
    # channels 0:C give +1 to each neighbour and -1 to the centre, C:2C +1 to
    # the centre: each point's gradient is its count as a neighbour
    counts = torch.bincount(idx.flatten().long(), minlength=16).float()
    torch.testing.assert_close(x.grad[0], counts[:, None].expand(16, 4))


@pytest.mark.parametrize("c,f,k,train", [(3, 64, 20, False), (64, 64, 20, False),
                                         (64, 128, 20, True), (64, 64, N - 1, False),
                                         (3, 64, N - 1, True)])
def test_each_edge_conv_matches_jax(monkeypatch, c, f, k, train):
    """One EdgeConv, converted weights, the JAX graph handed over: output
    within 2e-4 in eval mode and in train mode (batch statistics), and the
    updated statistics within 1e-5 of max|stat|."""
    rng = np.random.default_rng(c * f + k)
    x = rng.normal(size=(B, N, c)).astype(np.float32)
    jmodule = jdgcnn.EdgeConv(f, k)
    v = randomize(jax.jit(lambda a: jmodule.init(jax.random.PRNGKey(1), a, False))(x), c + f)
    graphs = JaxGraphs(monkeypatch)
    graphs.record()
    if train:
        want, mut = jmodule.apply(v, jnp.asarray(x), True, mutable=["batch_stats"])
    else:
        want = jmodule.apply(v, jnp.asarray(x), False)
    idx = graphs.stages[0][1]
    holder = torch.nn.Module()
    holder.edge, holder.bn = EdgeConv(c, f, k), BatchNorm(f)
    holder.load_state_dict(flax_to_state_dict(
        v, [("edge.0", ("conv",), "conv2d"), ("bn", ("bn",), "bn")]), strict=True)
    holder.train(train)
    module, bn = holder.edge, holder.bn
    monkeypatch.setattr(tdgcnn, "knn", lambda a, k: _t(idx))
    got = module(_t(x), bn)
    assert got.shape == (B, N, f)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    if train:
        for key, leaf in (("running_mean", "mean"), ("running_var", "var")):
            ref = np.asarray(mut["batch_stats"]["bn"][leaf])
            np.testing.assert_allclose(getattr(bn, key).numpy(), ref, rtol=0,
                                       atol=1e-5 * np.abs(ref).max())
    # the port's own graph on the same input, within the tie band
    full = np.asarray(square_distance(jnp.asarray(x), jnp.asarray(x)))
    assert_same_neighbours(ops.knn(_t(x), k=k).numpy(), idx, full)


# ------------------------------------------------------------- the models


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("k", [20, N - 1])
def test_eval_logits_match_jax(monkeypatch, name, k):
    xyz = cloud(k)
    kwargs = {"k": k}
    variables = jax_variables(name, xyz, seed=k, **kwargs)
    graphs = JaxGraphs(monkeypatch)
    graphs.record()
    jmodel = jax_get_model(name, 5, **kwargs)
    want = np.asarray(jax.jit(lambda x: jmodel.apply(variables, x, None, train=False))(xyz))
    differ = assert_graphs_within_the_tie_band(graphs.stages)
    model = get_model(name, 5, **kwargs)
    assert type(model) is MODELS[name]
    model.load_state_dict(flax_to_state_dict(variables, name), strict=True)
    model.eval()
    calls = graphs.port_replay()
    with torch.no_grad():
        got = model(_t(xyz), None).numpy()
    assert len(calls) == 4 and got.shape == (B, N, 5) == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert differ <= 2 * B * N * k * 4 // 1000  # a near tie is rare: at most 0.2% of picks


@pytest.mark.parametrize("name", sorted(MODELS))
def test_the_model_builds_its_graphs_without_help(monkeypatch, name):
    """Without the replay the port runs its own k-NN in every stage: four
    graphs, the first over xyz (C = 3), the others over 64 channels, and
    finite logits of the right shape; k = min(k, N - 1)."""
    model = get_model(name, 5, generator=torch.Generator().manual_seed(0)).eval()
    seen = []
    real = tdgcnn.knn

    def spy(x, k):
        seen.append((x.shape[-1], k))
        return real(x, k=k)

    monkeypatch.setattr(tdgcnn, "knn", spy)
    with torch.no_grad():
        out = model(torch.rand(B, 16, 3), None)
    assert out.shape == (B, 16, 5) and torch.isfinite(out).all()
    assert seen == [(3, 15), (64, 15), (64, 15), (64, 15)]
    if name == "dgcnn_global":  # one row of logits per cloud
        assert torch.equal(out, out[:, :1].expand_as(out))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_weight_round_trip_is_exact_and_complete(name):
    """JAX variables -> state_dict (strict load) -> JAX variables: every leaf
    back bit for bit, and no leaf left out on either side."""
    xyz = cloud(3, 64)
    variables = jax_variables(name, xyz, seed=3, k=16)
    model = get_model(name, 5, k=16)
    sd = flax_to_state_dict(variables, name)
    model.load_state_dict(sd, strict=True)
    assert set(sd) == set(model.state_dict())
    back = state_dict_to_flax(model.state_dict(), name)
    flat = lambda t: dict(jax.tree_util.tree_leaves_with_path(t))  # noqa: E731
    for col in ("params", "batch_stats"):
        want, got = flat(variables[col]), flat(back[col])
        assert set(got) == set(want), col
        for path, leaf in want.items():
            np.testing.assert_array_equal(got[path], np.asarray(leaf), err_msg=str(path))
    kinds = {kind for _, _, kind in MODEL_RULES[name]()}
    assert kinds == ({"conv2d", "conv1d", "bn"} | ({"linear"} if name == "dgcnn_global" else set()))


@pytest.mark.parametrize("name,names", [
    ("dgcnn", ["conv1.0.weight", "bn1.weight", "conv5.0.weight", "bn5.running_var",
               "local_bn.bias", "point_conv.0.weight", "point_conv.1.weight",
               "point_conv.3.bias", "point_conv.4.running_mean", "point_conv.6.weight"]),
    ("dgcnn_global", ["conv4.0.weight", "bn4.bias", "conv5.0.weight", "linear1.weight",
                      "bn6.weight", "linear2.bias", "bn7.running_var", "linear3.weight"])])
def test_parameters_carry_the_reference_torch_names(name, names):
    sd = get_model(name, 5).state_dict()
    for key in names:
        assert key in sd, key
    assert sd["conv1.0.weight"].shape == (64, 6, 1, 1)
    assert sd["conv2.0.weight"].shape == (64, 128, 1, 1)
    assert sd["conv5.0.weight"].shape == (1024, 320, 1)
    assert "conv1.0.bias" not in sd and "conv5.0.bias" not in sd
    if name == "dgcnn_global":
        assert sd["linear1.weight"].shape == (512, 2048) and "linear1.bias" not in sd
        assert sum(p.numel() for p in get_model(name, 5).parameters()) == 1_546_245
    else:
        assert sd["point_conv.0.weight"].shape == (512, 1344, 1)


@pytest.mark.parametrize("cls", [DGCNN, DGCNNGlobal])
def test_axis_name_is_not_ported(cls):
    """axis_name, refused until the parallel layer was ported, now syncs
    every BatchNorm over that mesh axis; graph_recall stays out."""
    from test_torch_cls_models import all_bns_synced

    assert all_bns_synced(cls(axis_name=None), None)
    assert all_bns_synced(cls(axis_name="data"), "data")
    with pytest.raises(TypeError):
        cls(graph_recall=0.95)
