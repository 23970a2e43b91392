"""The PyTorch port's RandLA-Net (``randlanet``, ``randlanet_ss``) and its
sampling ops against the JAX package, on the CPU.

Indices are held bit for bit: the stride subsets, the density-weighted
selection and the re-weighted k-NN selection, both fed the JAX package's
k-NN distances (the port's k-NN takes the direct distance form, the JAX
one the expanded form, whose values differ by its cancellation; the port's
k-NN is held to JAX's in tests/test_torch_knn.py), and the whole
density-weighted sampling on an integer grid, where both forms are exact.
The random draws are torch's and are held by their properties. Floats:
the linear upsampling within 1e-5 of ``jax.image.resize`` (values of
order 1), module and model outputs within the port's 2e-4 (PARITY.md §7).
The train steps are in tests/test_torch_randlanet_train.py, on the
helpers at the end of this file. Then configs/train_randlanet.yaml trains
one epoch through ``train_cli --device cpu`` and ``infer_cli blocks``
serves it.
"""

import torch_cpu  # noqa: F401  (first: torch's threads a worker)

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_bridge_tpu import losses as JL
from pointcloud_bridge_tpu.data import write_las
from pointcloud_bridge_tpu.data.synthetic import toy_bridge_scene
from pointcloud_bridge_tpu.models import get_model as jax_get_model
from pointcloud_bridge_tpu.models import randlanet as jrandla
from pointcloud_bridge_tpu.ops import grouping as jgrouping
from pointcloud_bridge_tpu.ops import sampling as jsampling
from pointcloud_bridge_tpu.utils.torch_import import convert_state_dict
from pointcloud_bridge_tpu_torch import infer_cli, losses, train_cli
from pointcloud_bridge_tpu_torch.config import Config
from pointcloud_bridge_tpu_torch.models import (
    LocalFeatureAggregation,
    LocalFeatureAggregationSS,
    get_model,
)
from pointcloud_bridge_tpu_torch.models import randlanet as trandla
from pointcloud_bridge_tpu_torch.ops import grouping, sampling
from pointcloud_bridge_tpu_torch.train import make_train_step
from pointcloud_bridge_tpu_torch.utils.weights import (
    flax_to_state_dict,
    randlanet_rules,
    state_dict_to_flax,
)

from test_torch_bristrunet import module_rules, randomize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-4
CLASS_WEIGHTS = np.array([0.7, 1.3, 2.0, 0.5, 1.1], np.float32)
SGD_LR = 0.1
RATIOS = ((22, 89), (89, 358), (358, 1433), (1433, 4096))


def _t(a):
    return torch.from_numpy(np.array(a))


def _cloud(seed, b, n, c=3):
    return np.random.default_rng(seed).uniform(size=(b, n, c)).astype(np.float32)


def jax_init_variables(jmodel, *args, seed=0, **kwargs):
    """The JAX module's variables at a seed, every parameter perturbed and
    every BatchNorm moved away from the identity (test_torch_bristrunet).
    The train steps start from these."""
    v = jax.jit(lambda *a: jmodel.init(jax.random.PRNGKey(seed), *a, **kwargs))(*args)
    v = {k: jax.tree_util.tree_map(np.asarray, jax.device_get(dict(v[k]))) for k in v}
    v.setdefault("batch_stats", {})
    return randomize(v, seed)


def jax_variables(jmodel, *args, seed=0, **kwargs):
    """Variables of the JAX module's shapes at a seed, drawn here as flax
    initialises them (the shapes by ``jax.eval_shape``, so no
    initialisation is compiled): a kernel normal over sqrt(fan in), a scale
    1, any other parameter 0; then every parameter perturbed and every
    BatchNorm moved away from the identity (test_torch_bristrunet's
    ``randomize``)."""
    shapes = jax.eval_shape(lambda *a: jmodel.init(jax.random.PRNGKey(seed), *a, **kwargs),
                            *args)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            a = rng.normal(size=leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        else:
            a = np.full(leaf.shape, 1.0 if name == "scale" else 0.0)
        return a.astype(np.float32)

    v = {k: jax.tree_util.tree_map_with_path(draw, dict(shapes[k])) for k in shapes}
    v.setdefault("batch_stats", {})
    return randomize(v, seed)


class JaxPicks:
    """The discrete picks of a forward (a k-NN graph, a partition, a top-k),
    taken from the JAX package and handed to the port, so that both compute
    on the same picks: a near tie that the port's direct distance form and
    JAX's expanded form (or two GEMMs' roundings) break apart would move a
    point by O(1) and say nothing about the port.

    ``sites`` are (JAX module, its function's name, port module, its
    function's name, the positions of the JAX outputs the port function
    returns, or None for all[, a predicate of the call's arguments: the
    calls it refuses run as they are on both sides]). ``record`` wraps the JAX functions to keep
    each call's outputs in call order (a debug callback on the primal
    values: also inside jit and under grad); ``replay`` makes them return
    what they recorded;
    ``port_replay`` makes the port's functions return it, in the same
    order, and returns the list of the calls it answered."""

    def __init__(self, monkeypatch, sites):
        self.monkeypatch, self.sites = monkeypatch, sites
        self.kept = {}
        self.calls = []

    def record(self):
        self.kept.clear()
        for jmod, jname, _, _, _, *when in self.sites:
            real, order = getattr(jmod, jname), []

            def recording(*a, real=real, order=order, jname=jname, when=when, **k):
                out = real(*a, **k)
                if when and not when[0](*a):
                    return out
                at = len(order)
                order.append(at)
                jax.debug.callback(lambda *v, at=at, jname=jname: self.kept.__setitem__(
                    (jname, at), [np.asarray(x) for x in v]), *jax.tree_util.tree_leaves(out))
                return out
            self.monkeypatch.setattr(jmod, jname, recording)

    def count(self, jname):
        return len({at for n, at in self.kept if n == jname})

    def replay(self):
        for jmod, jname, _, _, _, *when in self.sites:
            self._replace(jmod, jname, jname, None, jnp.asarray, when)

    def port_replay(self):
        self.calls = []
        for _, jname, pmod, pname, leaves, *when in self.sites:
            self._replace(pmod, pname, jname, leaves, lambda x: torch.from_numpy(x.copy()),
                          when)
        return self.calls

    def _replace(self, module, name, jname, leaves, convert, when):
        count, order, real = self.count(jname), [], getattr(module, name)
        assert count, f"{jname}: nothing recorded"

        def replaying(*a, **k):
            if when and not when[0](*a):
                return real(*a, **k)
            at = len(order) % count
            order.append(at)
            self.calls.append(name)
            kept = self.kept[(jname, at)]
            # floats in the type of the call's first float argument
            dtype = next((x.dtype for x in a if hasattr(x, "dtype")
                          and np.issubdtype(np.dtype(str(x.dtype).replace("torch.", "")),
                                            np.floating)), None)
            out = [convert(kept[i].astype(str(dtype).replace("torch.", ""))
                           if dtype is not None and np.issubdtype(kept[i].dtype, np.floating)
                           else kept[i]) for i in (leaves or range(len(kept)))]
            return out[0] if len(out) == 1 else tuple(out)
        self.monkeypatch.setattr(module, name, replaying)


# the graphs of each model: k-NN over xyz (randlanet), the re-weighted
# k-NN (randlanet_ss), four a forward
SITES = {"randlanet": [(jrandla, "knn", trandla, "knn", None)],
         "randlanet_ss": [(jrandla, "knn_stat_weighted", trandla, "knn_stat_weighted", None)]}


# ------------------------------------------------------------- sampling ops


def test_random_subsets_are_distinct_and_repeat_with_the_generator():
    rows = sampling.random_sample_indices(100, 35, 4, torch.Generator().manual_seed(3))
    assert rows.shape == (4, 35) and rows.dtype == torch.int32
    for r in rows:
        assert len(set(r.tolist())) == 35 and 0 <= int(r.min()) and int(r.max()) < 100
    again = sampling.random_sample_indices(100, 35, 4, torch.Generator().manual_seed(3))
    other = sampling.random_sample_indices(100, 35, 4, torch.Generator().manual_seed(4))
    assert torch.equal(rows, again) and not torch.equal(rows, other)
    assert not torch.equal(rows[0], rows[1])  # a permutation a row
    full = sampling.random_sample_indices(50, 50, 2, torch.Generator().manual_seed(0))
    assert all(sorted(r.tolist()) == list(range(50)) for r in full)


@pytest.mark.parametrize("n,npoint", [(64, 16), (300, 75), (512, 128)])
def test_density_selection_matches_jax_bit_for_bit(n, npoint, monkeypatch):
    """The selection of density-weighted sampling fed JAX's uniform draw and
    JAX's k-NN distances picks exactly what the JAX function picks with
    that key."""
    xyz = _cloud(n, 2, n)
    key = jax.random.PRNGKey(n)
    want = np.asarray(jsampling.density_weighted_sample_indices(key, jnp.asarray(xyz), npoint))
    u = np.asarray(jax.random.uniform(key, (2, n)))
    d2, idx = jgrouping.knn_with_distance(jnp.asarray(xyz), k=9)
    monkeypatch.setattr(grouping, "knn_with_distance", lambda x, k: (_t(d2), _t(idx)))
    got = sampling.density_weighted_select(_t(xyz), npoint, _t(u))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_density_sampling_matches_jax_on_an_integer_grid():
    """The whole op (the port's own k-NN) where both distance forms are
    exact: integer coordinates, duplicate points and equal distances."""
    xyz = np.random.default_rng(7).integers(0, 12, (2, 400, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jsampling.density_weighted_sample_indices(key, jnp.asarray(xyz), 100))
    got = sampling.density_weighted_select(_t(xyz), 100, _t(jax.random.uniform(key, (2, 400))))
    np.testing.assert_array_equal(got.numpy(), want)


def test_density_sampling_draws_distinct_points_from_the_generator():
    xyz = _t(_cloud(1, 2, 200))
    a = sampling.density_weighted_sample_indices(xyz, 50, torch.Generator().manual_seed(1))
    b = sampling.density_weighted_sample_indices(xyz, 50, torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and a.shape == (2, 50)
    assert all(len(set(r.tolist())) == 50 for r in a)


@pytest.mark.parametrize("n,k", [(512, 16), (128, 8), (32, 5), (8, 4), (6, 4)])
def test_stat_weighted_selection_matches_jax_bit_for_bit(n, k):
    """``knn_stat_select`` fed JAX's 2k-NN and its candidates' xyz gives
    JAX's indices exactly, at each RandLANetSS level's k (and k2 = min(2k,
    N) where N < 2k)."""
    xyz = _cloud(n + k, 2, n)
    want = np.asarray(jgrouping.knn_stat_weighted(jnp.asarray(xyz), k=k))
    k = min(k, n)
    d2, idx2 = jgrouping.knn_with_distance(jnp.asarray(xyz), k=min(2 * k, n))
    pts = xyz[np.arange(2)[:, None, None], np.asarray(idx2)]  # [B, N, 2k, 3]
    got = grouping.knn_stat_select(_t(pts), _t(d2), _t(idx2), k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_stat_weighted_knn_takes_no_gradient_and_keeps_near_points():
    xyz = _t(_cloud(3, 2, 256)).requires_grad_(True)
    idx = grouping.knn_stat_weighted(xyz, k=16)
    assert idx.shape == (2, 256, 16) and not idx.requires_grad
    two_k = grouping.knn(xyz, k=32)
    assert bool((idx.unsqueeze(-1) == two_k.unsqueeze(-2)).any(-1).all())


# --------------------------------------------------------------- upsampling


@pytest.mark.parametrize("n_in,n_out", RATIOS + ((3, 7), (64, 256)))
def test_linear_upsample_matches_jax_image_resize(n_in, n_out):
    """Values within 1e-5 and the gradient (a gather's backward) within 1e-5
    of ``jax.vjp`` through the JAX function, at the four RandLANet ratios."""
    x = np.random.default_rng(n_out).normal(size=(2, n_in, 5)).astype(np.float32)
    ct = np.random.default_rng(n_in).normal(size=(2, n_out, 5)).astype(np.float32)
    want, vjp = jax.vjp(lambda a: jrandla._linear_upsample(a, n_out), jnp.asarray(x))
    (want_g,) = vjp(jnp.asarray(ct))
    xt = _t(x).requires_grad_(True)
    got = trandla.linear_upsample(xt, n_out)
    got.backward(_t(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_g), rtol=0, atol=1e-5)


def test_linear_upsample_keeps_the_size_and_refuses_a_downsampling():
    x = torch.randn(1, 9, 2)
    assert trandla.linear_upsample(x, 9) is x
    with pytest.raises(ValueError, match="not an upsampling"):
        trandla.linear_upsample(x, 4)


# ------------------------------------------------------------------ modules


def _lfa_rules(prefix):
    """randlanet_rules of one level, without the level's prefixes."""
    return [(tp[len(prefix):], fp[1:], kind) for tp, fp, kind in randlanet_rules()
            if tp.startswith(prefix)]


@pytest.mark.parametrize("ss", [False, True])
def test_local_feature_aggregation_matches_jax(ss):
    xyz = jnp.asarray(_cloud(11, 2, 200))
    feats = jnp.asarray(np.random.default_rng(12).normal(size=(2, 200, 8)).astype(np.float32))
    jmod = (jrandla.LocalFeatureAggregationSS(16, 8) if ss
            else jrandla.LocalFeatureAggregation(16, 16))
    v = jax_variables(jmod, xyz, feats, train=False)
    want = np.asarray(jmod.apply(v, xyz, feats, train=False))
    mod = (LocalFeatureAggregationSS(8, 16, 8) if ss else LocalFeatureAggregation(8, 16, 16)).eval()
    rules = module_rules(mod) if ss else _lfa_rules("down_modules.0.localAgg.")
    mod.load_state_dict(flax_to_state_dict(v, rules), strict=True)
    got = mod(_t(xyz), _t(feats)).detach().numpy()
    assert got.shape == (2, 200, 16)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


# ------------------------------------------------------------------- models


def kept_indices(monkeypatch):
    """Spies on the gathers of each level's kept points, [B, s] indices:
    the JAX model's through a debug callback (also inside jit), the port's
    as they are called -> {"jax": {call: idx}, "port": [idx]}."""
    seen = {"jax": {}, "port": []}
    real_j, real_t = jrandla.index_points, trandla.index_points

    def jax_spy(points, idx):
        if idx.ndim == 2:
            at = len(seen["jax"])
            seen["jax"][at] = None
            jax.debug.callback(lambda i, at=at: seen["jax"].__setitem__(at, np.asarray(i)), idx)
        return real_j(points, idx)

    def port_spy(points, idx):
        if idx.dim() == 2:
            seen["port"].append(idx.numpy().copy())
        return real_t(points, idx)

    monkeypatch.setattr(jrandla, "index_points", jax_spy)
    monkeypatch.setattr(trandla, "index_points", port_spy)
    return seen


@pytest.mark.parametrize("name", ["randlanet", "randlanet_ss"])
def test_eval_logits_match_jax(name, monkeypatch):
    """B = 2 x 512 points, xyz and colours (the model reads xyz alone at
    d_in = 3); the levels keep 179/44/11/2 (randlanet) and 128/32/8/2
    points by their stride subsets, which are JAX's bit for bit, and the
    same in train mode without a sampling generator (as both trainers
    run). The port takes the JAX forward's four graphs (JaxPicks); its own
    graphs are held in the tests above and tests/test_torch_knn.py."""
    xyz, rgb = jnp.asarray(_cloud(20, 2, 512)), jnp.asarray(_cloud(21, 2, 512))
    jmodel = jax_get_model(name, 5)
    v = jax_variables(jmodel, xyz, rgb, train=False)
    seen = kept_indices(monkeypatch)
    picks = JaxPicks(monkeypatch, SITES[name])
    picks.record()
    want = np.asarray(jax.jit(lambda a, b: jmodel.apply(v, a, b, train=False))(xyz, rgb))
    calls = picks.port_replay()
    model = get_model(name, 5).eval()
    model.load_state_dict(flax_to_state_dict(v, name), strict=True)
    got = model(_t(xyz), _t(rgb)).detach().numpy()
    assert got.shape == (2, 512, 5) and len(calls) == 4
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    model.train()(_t(xyz), _t(rgb))
    assert len(seen["jax"]) == 8 and len(seen["port"]) == 16  # xyz and features a level
    for at, kept in sorted(seen["jax"].items()):
        np.testing.assert_array_equal(seen["port"][at], kept)
        np.testing.assert_array_equal(seen["port"][8 + at], kept)


@pytest.mark.parametrize("name", ["randlanet", "randlanet_ss"])
def test_sampling_generator_draws_in_train_mode_only(name):
    xyz = _t(_cloud(40, 2, 256))
    model = get_model(name, 5, generator=torch.Generator().manual_seed(0), dropout_rate=0.0)
    model.eval()
    ref = model(xyz)
    model.sampling_generator = torch.Generator().manual_seed(5)
    assert torch.equal(model(xyz), ref)  # eval mode keeps the stride subsets
    model.train()
    state = {k: v.clone() for k, v in model.state_dict().items()}
    a = model(xyz)
    model.load_state_dict(state)
    model.sampling_generator = torch.Generator().manual_seed(5)
    b = model(xyz)
    assert torch.equal(a, b) and torch.isfinite(a).all()
    model.load_state_dict(state)
    model.sampling_generator = None
    assert not torch.equal(model(xyz), a)


def test_randlanet_axis_name_is_refused():
    """axis_name, refused until the parallel layer was ported, now syncs
    every BatchNorm over that mesh axis; an unknown sampling is refused."""
    from test_torch_cls_models import all_bns_synced

    assert all_bns_synced(get_model("randlanet", 5, axis_name="data"), "data")
    with pytest.raises(ValueError, match="sampling"):
        get_model("randlanet", 5, sampling="fps")


# ------------------------------------------------------------------ weights


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + (k,)) if isinstance(v, dict) else {prefix + (k,): v})
    return out


@pytest.mark.parametrize("name", ["randlanet", "randlanet_ss"])
def test_weights_round_trip_exactly_and_completely(name):
    """state_dict -> flax -> state_dict bit for bit, every key both ways,
    and the flax tree has exactly the JAX model's leaves and shapes."""
    model = get_model(name, 5, generator=torch.Generator().manual_seed(1))
    sd = model.state_dict()
    back = flax_to_state_dict(state_dict_to_flax(sd, name), name)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    jmodel = jax_get_model(name, 5)
    x = jnp.asarray(_cloud(0, 1, 256))
    shapes = jax.eval_shape(lambda a: jmodel.init(jax.random.PRNGKey(0), a, None), x)
    flax = state_dict_to_flax(sd, name)
    for col in ("params", "batch_stats"):
        want = {p: tuple(s.shape) for p, s in _flat(jax.tree_util.tree_map(
            lambda a: a, dict(shapes[col]))).items()}
        assert {p: a.shape for p, a in _flat(flax[col]).items()} == want, col


def test_reference_state_dict_converts_through_the_jax_import_and_back():
    """``randlanet``'s names are the reference torch model's: its
    state_dict goes through the JAX package's ``convert_state_dict``
    (strict) to the same tree as ``state_dict_to_flax``, and back bit for
    bit."""
    sd = get_model("randlanet", 5, generator=torch.Generator().manual_seed(2)).state_dict()
    converted = convert_state_dict("randlanet", {k: v.numpy() for k, v in sd.items()})
    mine = state_dict_to_flax(sd, "randlanet")
    flat_c, flat_m = _flat(converted), _flat(mine)
    assert set(flat_c) == set(flat_m)
    for p, a in flat_c.items():
        np.testing.assert_array_equal(np.asarray(a), flat_m[p])
    back = flax_to_state_dict(converted, "randlanet")
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


# ------------------------------------------- helpers of the train-step tests


def jax_step(jmodel, variables, batch, dtype, compiler_options=None, cw=CLASS_WEIGHTS,
             lr=SGD_LR):
    """Loss, train-mode logits, gradients, updated batch_stats and one
    plain-SGD step's parameters of the JAX package, computing in ``dtype``;
    all as float64 numpy. In float32 the loss is the package's weighted
    cross-entropy, which computes in float32 (losses.py:50); in float64 the
    same formula in float64 (``wce``): through the train-mode BatchNorms a
    float32-rounded loss gradient moves the encoder's gradients by up to
    their own size. The step is compiled with XLA's ``compiler_options``:
    randlanet_ss's takes {"xla_disable_hlo_passes": "algsimp"}, since with
    XLA's algebraic simplifier its gradient of the encoder is up to 100% of
    max|g| from the same step run op by op, in float64 and in float32 (the
    JAX package's own trainer takes that gradient); without the pass it
    agrees with the op-by-op step, and the port's, to 1e-13."""
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), variables)
    b = {k: (np.asarray(x, dtype) if x.dtype == np.float32 else x) for k, x in batch.items()}
    loss_of = JL.weighted_cross_entropy if dtype == np.float32 else wce

    def loss_fn(params, stats, x, c, lbl):
        logits, mut = jmodel.apply({"params": params, "batch_stats": stats}, x, c, train=True,
                                   mutable=["batch_stats"])
        return loss_of(logits, lbl, jnp.asarray(cw, dtype)), (logits, mut["batch_stats"])

    args = (v["params"], v["batch_stats"], b["points"], b["colors"], b["labels"])
    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True)).lower(*args)
    (loss, (logits, stats)), grads = step.compile(compiler_options or {})(*args)
    assert logits.dtype == dtype
    out = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), {
        "loss": loss, "logits": logits, "grads": grads, "batch_stats": stats})
    out["sgd_params"] = jax.tree_util.tree_map(
        lambda p, g: np.asarray(p, np.float64) - lr * g, v["params"], out["grads"])
    return out


def wce(logits, labels, w):
    """Weighted cross-entropy in the logits' type, the formula of the JAX
    package's (losses.py:35-63) on either package's arrays."""
    xp = jnp if isinstance(logits, jax.Array) else torch
    logp = (jax.nn.log_softmax(logits, axis=-1) if xp is jnp
            else torch.log_softmax(logits, dim=-1))
    c = logits.shape[-1]
    logp, labels = logp.reshape(-1, c), labels.reshape(-1)
    picked = (xp.take_along_axis(logp, labels[:, None], axis=-1) if xp is jnp
              else logp.gather(-1, labels[:, None].long()))[:, 0]
    wl = w[labels]
    return -(picked * wl).sum() / wl.sum()


def jax_step64(jmodel, variables, batch, picks, compiler_options=None):
    """The JAX float64 step, recording its picks; then the port's functions
    replay them (``picks.port_replay``)."""
    picks.record()
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        want64 = jax_step(jmodel, variables, batch, np.float64, compiler_options)
    finally:
        jax.config.update("jax_enable_x64", x64)
    picks.port_replay()
    return want64


def port_step(make_model, name, variables, batch, dtype=torch.float32, cw=CLASS_WEIGHTS,
              lr=SGD_LR):
    """The port's train-mode step from the same variables, computing in
    ``dtype``: loss, logits, gradients and statistics as flax trees of
    float64, and one SGD step, through ``make_train_step`` (float32, the
    trainer's loss) or params - lr * g (float64, ``wce``)."""
    def port_model():
        model = make_model()
        model.load_state_dict(flax_to_state_dict(variables, name), strict=True)
        return model.to(dtype).train()

    tb = {"points": _t(batch["points"]).to(dtype), "colors": _t(batch["colors"]).to(dtype),
          "labels": _t(batch["labels"]).long()}
    cwt = torch.from_numpy(np.asarray(cw)).to(dtype)
    model = port_model()
    logits = model(tb["points"], tb["colors"])
    f32 = dtype == torch.float32
    loss = (losses.weighted_cross_entropy if f32 else wce)(logits, tb["labels"], cwt)
    loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    grads_or_0 = {k: torch.zeros_like(p) if p.grad is None else p.grad
                  for k, p in model.named_parameters()}
    if f32:
        sgd_model = port_model()
        sgd_loss = float(make_train_step(sgd_model, Config().loss, torch.optim.SGD(
            sgd_model.parameters(), lr=lr))(tb, lr, cwt)["loss"])
        sgd = sgd_model.state_dict()
    else:
        sgd_loss, sgd = float(loss.detach()), {k: p.detach() - lr * grads_or_0[k]
                                               for k, p in model.named_parameters()}
    to64 = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), t)  # noqa: E731
    flax = lambda sd: state_dict_to_flax(sd, name)  # noqa: E731
    return {
        "loss": float(loss.detach()), "sgd_loss": sgd_loss,
        "logits": logits.detach().double().numpy(),
        "grads": to64(flax(grads_or_0)["params"]),
        "batch_stats": to64(flax(model.state_dict())["batch_stats"]),
        "sgd_params": to64(flax(sgd)["params"]),
        "torch_grads": grads,
    }


# ------------------------------------------------------ the recipe, end to end


def test_the_recipe_trains_through_train_cli_and_infer_cli_serves_it(tmp_path, monkeypatch,
                                                                     capsys):
    """configs/train_randlanet.yaml as a user runs it (weighted block
    sampling, the plateau scheduler, Adam), with the data directories, a
    small block and one epoch as flags, on the CPU; then ``infer_cli
    blocks`` serves the checkpoint it wrote."""
    for sub, seed in (("train", 0), ("val", 1)):
        d = tmp_path / sub
        d.mkdir()
        xyz, rgb, labels = toy_bridge_scene(3000, seed=seed)
        write_las(str(d / f"scene{seed}.las"), xyz, rgb, labels)
    monkeypatch.chdir(tmp_path)
    recipe = os.path.join(REPO, "configs", "train_randlanet.yaml")
    cfg = Config.from_yaml(recipe)
    assert (cfg.model.name, cfg.train.batch_size, cfg.data.num_points, cfg.train.scheduler,
            cfg.data.weighted_sampling) == ("randlanet", 16, 4096, "plateau", True)
    out = train_cli.main([
        "--config", recipe, "--train-dir", str(tmp_path / "train"),
        "--val-dir", str(tmp_path / "val"), "--num-points", "128", "--batch-size", "4",
        "--num-epochs", "1", "--device", "cpu"])
    exp = out["exp_dir"]
    assert [r["epoch"] for r in out["history"]] == [1]
    row = out["history"][0]
    assert np.isfinite(row["train_loss"]) and np.isfinite(row["val_loss"])
    for name in ("best_model", "latest_checkpoint"):
        assert os.path.exists(os.path.join(exp, name)), name
    capsys.readouterr()
    infer_cli.main(["blocks", "--checkpoint", exp, "--model", "randlanet",
                    "--data-dir", str(tmp_path / "val"), "--out-dir", str(tmp_path / "served"),
                    "--num-points", "128", "--batch-size", "4", "--device", "cpu"])
    assert "GLOBAL mIoU=" in capsys.readouterr().out
    cm = np.loadtxt(tmp_path / "served" / "confusion_matrix.csv", delimiter=",")
    assert cm.shape == (5, 5) and cm.sum() > 0 and cm.sum() % 128 == 0
