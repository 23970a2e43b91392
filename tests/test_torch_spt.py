"""The PyTorch port's SuperPoint Transformer (``spt``,
``superpoint_transformer``) against the JAX package, on the CPU.

The graph operations over any ``edge_index``: segment sums and the segment
softmax with repeated edges, masked edges and nodes that no edge reaches,
values and gradients; the attention, encoder and MLP modules; the
transformer over a general graph. Then the point-level model: its graph
(the 9 nearest centroids, self dropped: the port's k-NN, bit for bit with
JAX's on these inputs), its eval logits and one train-mode step on the JAX
forward's partition and graph (``JaxPicks``), the step held in float64 as
tests/test_torch_randlanet_train.py holds RandLA-Net's. Floats within
1e-6 for the graph operations and 2e-4 for modules and logits (PARITY.md
§7).
"""

import torch_cpu  # noqa: F401  (first: torch's threads a worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_bridge_tpu import ops as jops
from pointcloud_bridge_tpu.models import get_model as jax_get_model
from pointcloud_bridge_tpu.models import spg as jspg
from pointcloud_bridge_tpu.models import spt as jspt
from pointcloud_bridge_tpu_torch.models import (
    GraphMLP,
    GraphMultiHeadAttention,
    GraphTransformerEncoder,
    SuperPointTransformer,
    get_model,
)
from pointcloud_bridge_tpu_torch.models import spt as tspt
from pointcloud_bridge_tpu_torch.ops import grouping
from pointcloud_bridge_tpu_torch.ops import knn as port_knn
from pointcloud_bridge_tpu_torch.utils.weights import flax_to_state_dict

from test_torch_bristrunet import module_rules
from test_torch_randlanet import JaxPicks, _cloud, _t, jax_variables
from test_torch_randlanet import test_weights_round_trip_exactly_and_completely as round_trip
from test_torch_randlanet_train import check, check_loss_and_logits, train_steps

TOL = 2e-4
# the float64 step's band: flax's LayerNorm takes its variance as E[x^2] -
# E[x]^2, which in float64 loses 1e-13 at a mean of 10 and 1e-11 at 100
# (torch's takes it from x - mean), and the residual stream carries that
F64 = 1e-6
KW = {"superpoint_size": 8}  # S = 64 superpoints of 512 points
SITES = [(jspg, "kmeans_partition", tspt, "kmeans_partition", None),
         (jops, "knn", tspt, "knn", None)]


def _graph(seed, s=30, e=150, masked=0.3):
    """A graph over s nodes with e edges: repeated edges, masked edges, and
    node s - 1 reached by none -> (edge_index [2, E] int32, mask [E] bool)."""
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, s - 1, size=(2, e)).astype(np.int32)
    ei[:, 10:20] = ei[:, :10]  # ten edges twice
    mask = rng.uniform(size=e) > masked
    mask[:10] = True
    return ei, mask


# ---------------------------------------------------------- graph operations


def test_segment_sum_matches_jax_with_its_gradient():
    rng = np.random.default_rng(0)
    data = rng.normal(size=(150, 7)).astype(np.float32)
    seg = rng.integers(0, 29, size=150).astype(np.int32)  # segment 29 empty
    ct = rng.normal(size=(30, 7)).astype(np.float32)
    want, vjp = jax.vjp(lambda d: jax.ops.segment_sum(d, jnp.asarray(seg), 30), jnp.asarray(data))
    (want_g,) = vjp(jnp.asarray(ct))
    dt = _t(data).requires_grad_(True)
    got = grouping.segment_sum(dt, _t(seg), 30)
    got.backward(_t(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-6)
    assert not got[29].any()
    np.testing.assert_array_equal(dt.grad.numpy(), np.asarray(want_g))  # a gather


def test_segment_sum_is_the_group_backward_order():
    """Each segment a left fold of its rows in ascending row order: the
    order the group-backward kernel adds in (its emulation, bit for bit)."""
    rng = np.random.default_rng(1)
    data = torch.from_numpy(rng.normal(size=(300, 5)).astype(np.float32))
    seg = torch.from_numpy(rng.integers(0, 12, size=300).astype(np.int32))
    got = grouping.segment_sum(data, seg, 12)
    want = grouping.group_backward_order(data.reshape(1, 300, 1, 5), seg.reshape(1, 300, 1),
                                         12, 0, 5)[0]
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_segment_softmax_matches_jax():
    ei, mask = _graph(2)
    scores = np.random.default_rng(3).normal(size=(150, 4)).astype(np.float32)
    scores = np.where(mask[:, None], scores, -1e9).astype(np.float32)
    ct = np.random.default_rng(4).normal(size=(150, 4)).astype(np.float32)
    dst = jnp.asarray(ei[1])
    want, vjp = jax.vjp(lambda x: jspt._segment_softmax(x, dst, 30), jnp.asarray(scores))
    (want_g,) = vjp(jnp.asarray(ct))
    st = _t(scores).requires_grad_(True)
    got = tspt.segment_softmax(st, _t(ei[1]), 30)
    got.backward(_t(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-6)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(want_g), rtol=0, atol=1e-6)


# ------------------------------------------------------------------ modules


def _load(mod, v):
    """``mod`` with the flax variables ``v`` by its module names, its
    LayerNorms among them."""
    rules = module_rules(mod) + [(name, tuple(name.split(".")), "ln")
                                 for name, m in mod.named_modules()
                                 if isinstance(m, torch.nn.LayerNorm)]
    mod.load_state_dict(flax_to_state_dict(v, rules), strict=True)
    return mod.eval()


@pytest.mark.parametrize("edge_attr", [False, True])
def test_graph_attention_matches_jax_over_repeats_and_masked_edges(edge_attr):
    """Values within 2e-4 in float32; the gradient of x and of every
    parameter in float64, op by op on the JAX side, within 1e-9 of max
    (and 1e-12: k's bias moves every score into a node alike, so its
    gradient is exactly 0)."""
    ei, mask = _graph(5)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(30, 32)).astype(np.float32)
    attr = rng.normal(size=(150, 6)).astype(np.float32) if edge_attr else None
    jmod = jspt.GraphMultiHeadAttention(32, 4)
    args = (jnp.asarray(ei), None if attr is None else jnp.asarray(attr), jnp.asarray(mask))
    v = jax_variables(jmod, jnp.asarray(x), *args)
    want = np.asarray(jmod.apply(v, jnp.asarray(x), *args))
    mod = _load(GraphMultiHeadAttention(32, 4, edge_dim=6 if edge_attr else None), v)
    got = mod(_t(x), _t(ei), None if attr is None else _t(attr), _t(mask))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL, atol=TOL)

    ct = rng.normal(size=(30, 32))
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        p64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v["params"])
        a64 = (args[0], None if attr is None else jnp.asarray(attr, jnp.float64), args[2])
        _, vjp = jax.vjp(lambda p, xx: jmod.apply({"params": p}, xx, *a64), p64,
                         jnp.asarray(x, jnp.float64))
        gp, gx = vjp(jnp.asarray(ct))
        gp, gx = jax.tree_util.tree_map(np.asarray, gp), np.asarray(gx)
    finally:
        jax.config.update("jax_enable_x64", x64)
    mod = mod.double()
    xt = torch.from_numpy(x.astype(np.float64)).requires_grad_(True)
    mod(xt, _t(ei), None if attr is None else torch.from_numpy(attr.astype(np.float64)),
        _t(mask)).backward(torch.from_numpy(ct))
    np.testing.assert_allclose(xt.grad.numpy(), gx, rtol=0, atol=1e-9 * np.abs(gx).max())
    for name, p in mod.named_parameters():
        path = name.split(".")
        want_p = gp[path[0]]["kernel" if path[1] == "weight" else "bias"]
        got_p = p.grad.numpy().T if path[1] == "weight" else p.grad.numpy()
        np.testing.assert_allclose(got_p, want_p, rtol=0, atol=1e-9 * np.abs(want_p).max()
                                   + 1e-12, err_msg=name)


def test_encoder_and_mlp_match_jax():
    ei, mask = _graph(7)
    rng = np.random.default_rng(8)
    x = jnp.asarray(rng.normal(size=(30, 32)).astype(np.float32))
    attr = jnp.asarray(rng.normal(size=(150, 6)).astype(np.float32))
    jmod = jspt.GraphTransformerEncoder(32, 4)
    v = jax_variables(jmod, x, jnp.asarray(ei), attr, jnp.asarray(mask))
    want = np.asarray(jmod.apply(v, x, jnp.asarray(ei), attr, jnp.asarray(mask)))
    got = _load(GraphTransformerEncoder(32, 4, edge_dim=6), v)(
        _t(x), _t(ei), _t(attr), _t(mask)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    jmod = jspt.GraphMLP((48, 16))
    v = jax_variables(jmod, x)
    want = np.asarray(jmod.apply(v, x))
    got = _load(GraphMLP(32, (48, 16)), v)(_t(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_transformer_over_a_general_graph_matches_jax():
    """SuperPointTransformer alone over edges with repeats and masks, no
    edge attributes (as its JAX signature allows)."""
    ei, mask = _graph(9, s=40, e=300)
    x = jnp.asarray(np.random.default_rng(10).normal(size=(40, 12)).astype(np.float32))
    jmod = jspt.SuperPointTransformer(5, 32, 2, 4)
    v = jax_variables(jmod, x, jnp.asarray(ei), None, jnp.asarray(mask))
    want = np.asarray(jmod.apply(v, x, jnp.asarray(ei), None, jnp.asarray(mask)))
    mod = _load(SuperPointTransformer(5, 32, 2, 4, in_channels=12), v)
    got = mod(_t(x), _t(ei), None, _t(mask)).detach().numpy()
    assert got.shape == (40, 5)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


# -------------------------------------------------------------------- model


def test_the_superpoint_graph_matches_jax_bit_for_bit():
    """The 9 nearest centroids (self first, then dropped) on the JAX
    package's k-means centroids: the port's k-NN against JAX's."""
    _, cent, _ = jspg.kmeans_partition(jnp.asarray(_cloud(11, 2, 512)), 64, 3)
    want = np.asarray(jops.knn(cent, k=9))
    got = port_knn(_t(cent), k=9)
    np.testing.assert_array_equal(got.numpy(), want)
    assert bool((got[..., 0] == torch.arange(64)).all())


@pytest.fixture(scope="module")
def jax_run():
    """(JAX variables, JAX eval logits recording the picks, the picks, the
    inputs), once for the file: ``superpoint_transformer`` names the same
    JAX class as ``spt``."""
    assert type(jax_get_model("superpoint_transformer", 5)) is type(jax_get_model("spt", 5))
    mp = pytest.MonkeyPatch()
    try:
        xyz, rgb = jnp.asarray(_cloud(20, 2, 512)), jnp.asarray(_cloud(21, 2, 512))
        jmodel = jax_get_model("spt", 5, **KW)
        v = jax_variables(jmodel, xyz, rgb, train=False)
        picks = JaxPicks(mp, SITES)
        picks.record()
        want = np.asarray(jax.jit(lambda a, b: jmodel.apply(v, a, b, train=False))(xyz, rgb))
        return v, want, picks, (xyz, rgb)
    finally:
        mp.undo()


@pytest.mark.parametrize("name", ["spt", "superpoint_transformer"])
def test_eval_logits_match_jax(name, jax_run, monkeypatch):
    """B = 2 x 512 points with colours, 64 superpoints, the batch as one
    graph of 128 nodes and 1024 edges; the port takes the JAX forward's
    partition and graph."""
    v, want, picks, (xyz, rgb) = jax_run
    picks.monkeypatch = monkeypatch
    calls = picks.port_replay()
    model = get_model(name, 5, **KW).eval()
    model.load_state_dict(flax_to_state_dict(v, name), strict=True)
    got = model(_t(xyz), _t(rgb)).detach().numpy()
    assert got.shape == (2, 512, 5) and calls == ["kmeans_partition", "knn"]
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_axis_name_is_refused():
    """axis_name, refused until the parallel layer was ported, now syncs
    every BatchNorm over that mesh axis."""
    from test_torch_cls_models import all_bns_synced

    assert all_bns_synced(get_model("spt", 5, axis_name="data"), "data")


@pytest.mark.parametrize("name", ["spt", "superpoint_transformer"])
def test_weights_round_trip(name):
    round_trip(name)


# ----------------------------------------------------------- one train step


@pytest.fixture(scope="module")
def step():
    rng = np.random.default_rng(3)
    batch = {"points": rng.uniform(-1.0, 1.0, size=(2, 512, 3)).astype(np.float32),
             "colors": rng.uniform(size=(2, 512, 3)).astype(np.float32),
             "labels": rng.integers(0, 5, size=(2, 512)).astype(np.int32)}
    mp = pytest.MonkeyPatch()
    try:
        return train_steps("spt", lambda: get_model("spt", 5, dropout=0.0, **KW),
                           jax_get_model("spt", 5, dropout=0.0, **KW), batch, SITES, mp)
    finally:
        mp.undo()


MODULES = ["input_proj", "layer0", "layer1", "layer2", "layer3", "output_proj"]


def test_train_loss_and_logits_match_jax(step):
    check_loss_and_logits(step, (2, 512, 5), rel64=1e-8, f64=F64)


@pytest.mark.parametrize("module", MODULES)
def test_train_gradients_match_jax_in_float64(step, module):
    check("grads", module, F64, {"grads": step[0]["grads"]["spt"]},
          {"grads": step[2]["grads"]["spt"]})


@pytest.mark.parametrize("module", MODULES)
def test_train_batch_stats_match_jax(step, module):
    want, got, got64 = ({"batch_stats": s["batch_stats"]["spt"]} for s in step)
    check("batch_stats", module, 1e-5, want, got)
    check("batch_stats", module, F64, want, got64)


@pytest.mark.parametrize("module", MODULES)
def test_sgd_step_matches_jax_in_float64(step, module):
    check("sgd_params", module, F64, {"sgd_params": step[0]["sgd_params"]["spt"]},
          {"sgd_params": step[2]["sgd_params"]["spt"]})


def test_every_parameter_gets_a_finite_gradient(step):
    """Present, finite and non-zero in the float32 step, but for the biases
    that a train-mode BatchNorm takes out again (each GraphMLP's lin0, the
    LayerNorm ``norm2`` in front of the feed-forward's, and the last
    layer's ffn.lin1, whose shift reaches output_proj's BatchNorm through
    a Dense alone) and those that
    shift every score into a node alike (``edge_proj``, and ``k``, whose
    bias adds q_i . b to each of node i's scores): exactly 0 in float64."""
    grads, grads64 = step[1]["torch_grads"], step[2]["torch_grads"]
    zero = {k for k, g in grads64.items() if k.endswith(".bias") and g.abs().max() <= 1e-12}
    assert zero == ({"spt.input_proj.lin0.bias", "spt.output_proj.lin0.bias"}
                    | {f"spt.layer{i}.ffn.lin0.bias" for i in range(4)}
                    | {f"spt.layer{i}.{m}.bias" for i in range(4)
                       for m in ("attn.edge_proj", "attn.k", "norm2")}
                    | {"spt.layer3.ffn.lin1.bias"})
    for key, g in grads.items():
        assert g is not None and torch.isfinite(g).all(), key
        if key not in zero:
            assert g.abs().max() > 0, key
