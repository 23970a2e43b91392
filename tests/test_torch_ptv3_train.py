"""Training of the PyTorch port's PTv3 family against the JAX package, on the
CPU: one train-mode step a module and a model, dropout, and the training and
inference CLIs.

Modules: the gradient of ``sum(out * cotangent)`` with respect to every
parameter and input of the port's module and of the flax module
(``train=True``, dropout 0) on the same numpy inputs and converted weights,
float32 against float32 within 5e-5 * max(1, max|g|): sums over a few hundred
rows in another order, and nothing that amplifies them.

Whole models, with the method of tests/test_torch_train.py: the JAX step runs
in float32 and in float64, and the port must be within a base tolerance of
the float64 step (logits 2e-4, gradients 2e-4 * max|g| + 1e-6, ``head_bn``
statistics 1e-5 * max|stat|, SGD parameters 1e-6) plus twice the JAX
package's own float32 error on that leaf; the loss agrees with the float32
step within 1e-5 relative. Dropout is 0 in both packages (their generators
give different masks); the port's dropout is tested on its own.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pointcloud_bridge_tpu import losses as JL
from pointcloud_bridge_tpu.config import Config as JaxConfig
from pointcloud_bridge_tpu.data import write_las
from pointcloud_bridge_tpu.data.synthetic import toy_bridge_scene
from pointcloud_bridge_tpu.models import get_model as jax_get_model
from pointcloud_bridge_tpu.models import ptv3 as jptv3
from pointcloud_bridge_tpu.models import ptv3_pooled as jpooled
from pointcloud_bridge_tpu.train.loop import TrainState
from pointcloud_bridge_tpu.train.loop import make_train_step as jax_make_train_step
from pointcloud_bridge_tpu_torch import infer_cli, losses, train_cli
from pointcloud_bridge_tpu_torch.config import Config
from pointcloud_bridge_tpu_torch.models import (
    Dropout,
    PointAttention,
    PointTransformerBlock,
    SerializedPool,
    SerializedUnpool,
    get_model,
)
from pointcloud_bridge_tpu_torch.train import make_train_step, train
from pointcloud_bridge_tpu_torch.utils.checkpoint import restore_checkpoint
from pointcloud_bridge_tpu_torch.utils.weights import (
    flax_to_state_dict,
    ptv3_pooled_rules,
    ptv3_rules,
    state_dict_to_flax,
)

from test_torch_bristrunet import randomize
from test_torch_ptv3 import FLAT, POOLED, POOLED_RULES, module_rules

MODULE_GRAD_TOL = 5e-5
CLASS_WEIGHTS = np.array([0.7, 1.3, 2.0, 0.5, 1.1], np.float32)
SGD_LR = 0.1
NO_DROPOUT = dict(drop_rate=0.0, head_drop_rate=0.0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ------------------------------------------------------------------ modules


def module_gradients(jmodule, tmodule, arrays, diff, **jkw):
    """Gradients of sum(out * cotangent) in both packages. ``arrays`` are
    the module's numpy inputs, ``diff`` the indices of those that get a
    gradient; a module with two outputs is weighed on the first ->
    (port parameter gradients as a flax tree, JAX's, port input gradients,
    JAX's)."""
    jargs = [jnp.asarray(a) for a in arrays]
    variables = randomize(
        jax.jit(lambda *a: jmodule.init(jax.random.PRNGKey(0), *a, **jkw))(*jargs))
    first = lambda out: out[0] if isinstance(out, tuple) else out  # noqa: E731
    shape = first(jax.eval_shape(lambda *a: jmodule.apply(variables, *a, **jkw), *jargs)).shape
    cot = np.random.default_rng(7).normal(size=shape).astype(np.float32)

    def jloss(params, *a):
        return (first(jmodule.apply({"params": params}, *a, **jkw)) * cot).sum()

    jgrads = jax.jit(jax.grad(jloss, argnums=(0,) + tuple(i + 1 for i in diff)))(
        variables["params"], *jargs)

    rules = module_rules(tmodule)
    tmodule.load_state_dict(flax_to_state_dict(variables, rules), strict=True)
    tmodule.train()
    targs = [_t(a) for a in arrays]
    for i in diff:
        targs[i].requires_grad_()
    (first(tmodule(*targs)) * _t(cot)).sum().backward()
    pgrads = state_dict_to_flax({k: p.grad for k, p in tmodule.named_parameters()}, rules)
    return pgrads["params"], jgrads[0], [targs[i].grad for i in diff], jgrads[1:]


def assert_module_gradients(got_p, want_p, got_x, want_x):
    got, want = _leaves(got_p), _leaves(want_p)
    assert set(got) == set(want) and want
    for k, w in want.items():
        assert np.abs(got[k] - w).max() <= MODULE_GRAD_TOL * max(1.0, np.abs(w).max()), k
    assert any(np.abs(w).max() > 1e-2 for w in want.values())
    for g, w in zip(got_x, want_x):
        w = np.asarray(w)
        assert np.abs(w).max() > 1e-3
        assert np.abs(g.numpy() - w).max() <= MODULE_GRAD_TOL * max(1.0, np.abs(w).max())


@pytest.mark.parametrize("window", [0, 64], ids=["global", "windowed"])
def test_point_attention_gradients_match_jax(rng, window):
    x = rng.normal(size=(2, 256, 32)).astype(np.float32)
    pos = rng.normal(size=(2, 256, 32)).astype(np.float32)
    assert_module_gradients(*module_gradients(
        jptv3.PointAttention(32, 2, window_size=window),
        PointAttention(32, 2, window_size=window), [x, pos], (0, 1), train=True))


@pytest.mark.parametrize("window", [0, 64], ids=["global", "windowed"])
def test_point_transformer_block_gradients_match_jax(rng, window):
    x = rng.normal(size=(2, 256, 32)).astype(np.float32)
    pos = rng.normal(size=(2, 256, 32)).astype(np.float32)
    assert_module_gradients(*module_gradients(
        jptv3.PointTransformerBlock(32, 2, window_size=window),
        PointTransformerBlock(32, 2, window_size=window), [x, pos], (0, 1), train=True))


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "repeated_points"])
def test_serialized_pool_gradients_match_jax(rng, ties):
    """The max over a segment sends its gradient to the largest child; where
    children tie (a padded block repeats points) both packages split it
    evenly among them."""
    x = rng.normal(size=(2, 256, 32)).astype(np.float32)
    if ties:
        x[:, 1::4] = x[:, 0::4]  # two equal children in every segment
        x[:, 128:] = x[:, 128:129]  # whole segments of one point
    xyz = rng.uniform(size=(2, 256, 3)).astype(np.float32)
    assert_module_gradients(*module_gradients(
        jpooled.SerializedPool(4, 48), SerializedPool(4, 32, 48), [x, xyz], (0,)))


def test_serialized_unpool_gradients_match_jax(rng):
    """The repeat after ``proj_up`` sums the gradients of a parent's children."""
    coarse = rng.normal(size=(2, 64, 48)).astype(np.float32)
    skip = rng.normal(size=(2, 256, 32)).astype(np.float32)
    assert_module_gradients(*module_gradients(
        jpooled.SerializedUnpool(4, 32), SerializedUnpool(4, 48, 32), [coarse, skip], (0, 1)))


# ------------------------------------------------------------- whole models

CONFIGS = {
    "ptv3_global": ("ptv3", dict(FLAT, window_size=0), ptv3_rules(2)),
    "ptv3_windowed": ("ptv3", dict(FLAT, window_size=64), ptv3_rules(2)),
    "ptv3_pooled": ("ptv3_pooled", POOLED, POOLED_RULES),
}


def _batch():
    rng = np.random.default_rng(0)
    return {
        "points": rng.uniform(-1.0, 1.0, size=(2, 256, 3)).astype(np.float32),
        "colors": rng.uniform(size=(2, 256, 3)).astype(np.float32),
        "labels": rng.integers(0, 5, size=(2, 256)).astype(np.int32),
    }


def _jax_step(name, kwargs, variables, b, dtype):
    """Loss, train-mode logits, gradients, updated batch_stats and one
    plain-SGD step's parameters of the JAX package, computing in ``dtype``
    (the modules inherit the type of their weights and inputs)."""
    jmodel = jax_get_model(name, 5, **NO_DROPOUT, **kwargs)
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), variables)
    b = {k: (np.asarray(x, dtype) if x.dtype == np.float32 else x) for k, x in b.items()}
    cw = jnp.asarray(CLASS_WEIGHTS, dtype)

    def loss_fn(params, stats, x, c, lbl):
        logits, mut = jmodel.apply(
            {"params": params, "batch_stats": stats}, x, c, train=True,
            mutable=["batch_stats"],
        )
        return JL.weighted_cross_entropy(logits, lbl, cw), (logits, mut["batch_stats"])

    (loss, (logits, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"], v["batch_stats"], b["points"], b["colors"], b["labels"]
    )
    assert logits.dtype == dtype
    state = TrainState(
        step=jnp.zeros((), jnp.int32), params=v["params"], batch_stats=v["batch_stats"],
        opt_state=optax.identity().init(None),
    )
    sgd, _ = jax_make_train_step(jmodel, JaxConfig().loss, optax.identity(), donate=False)(
        state, {k: jnp.asarray(x) for k, x in b.items()}, jnp.asarray(SGD_LR, dtype), cw,
        jax.random.PRNGKey(0),
    )
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), {
        "loss": loss, "logits": logits, "grads": grads, "batch_stats": stats,
        "sgd_params": sgd.params,
    })


@pytest.fixture(scope="module", params=list(CONFIGS))
def step(request):
    """(JAX float32, JAX float64, port) results of one train step."""
    name, kwargs, rules = CONFIGS[request.param]
    b = _batch()
    jmodel = jax_get_model(name, 5, **kwargs)
    variables = randomize(jax.jit(
        lambda x, c: jmodel.init(jax.random.PRNGKey(0), x, c, train=False)
    )(b["points"], b["colors"]))
    want32 = _jax_step(name, kwargs, variables, b, np.float32)
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        want64 = _jax_step(name, kwargs, variables, b, np.float64)
    finally:
        jax.config.update("jax_enable_x64", x64)

    def port_model():
        model = get_model(name, 5, **NO_DROPOUT, **kwargs)
        model.load_state_dict(flax_to_state_dict(variables, rules), strict=True)
        return model

    tb = {"points": _t(b["points"]), "colors": _t(b["colors"]), "labels": _t(b["labels"]).long()}
    cw = _t(CLASS_WEIGHTS)
    model = port_model().train()
    logits = model(tb["points"], tb["colors"])
    loss = losses.weighted_cross_entropy(logits, tb["labels"], cw)
    loss.backward()
    sgd_model = port_model()
    metrics = make_train_step(sgd_model, Config().loss, torch.optim.SGD(
        sgd_model.parameters(), lr=SGD_LR))(tb, SGD_LR, cw)
    to64 = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), t)  # noqa: E731
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert all(g is not None for g in grads.values())
    got = {
        "loss": float(loss.detach()),
        "sgd_loss": float(metrics["loss"]),
        "logits": logits.detach().double().numpy(),
        "grads": to64(state_dict_to_flax(grads, rules)["params"]),
        "batch_stats": to64(state_dict_to_flax(model.state_dict(), rules)["batch_stats"]),
        "sgd_params": to64(state_dict_to_flax(sgd_model.state_dict(), rules)["params"]),
    }
    return want32, want64, got


def _check(key, base, step):
    """Per leaf: |port - ref64| <= base(ref64) + 2 |jax32 - ref64|."""
    want32, want64, got = step
    ref, j32, port = (_leaves({"": t[key]}) for t in (want64, want32, got))
    assert set(ref) == set(j32) == set(port) and ref
    for path, r in ref.items():
        assert port[path].shape == r.shape, path
        err = np.abs(port[path] - r).max()
        tol = base(r) + 2 * np.abs(j32[path] - r).max()
        assert err <= tol, f"{key}{path}: |port - f64| {err:.3g} > {tol:.3g}"


def test_ptv3_train_loss_matches_jax(step):
    want32, want64, got = step
    np.testing.assert_allclose(got["loss"], want32["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["sgd_loss"], want32["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["loss"], want64["loss"], rtol=1e-5)


def test_ptv3_train_mode_logits_match_jax(step):
    assert step[2]["logits"].shape == (2, 256, 5)
    _check("logits", lambda r: 2e-4, step)


def test_ptv3_gradients_match_jax(step):
    """Every gradient leaf, the attention Function's backward included."""
    grads = _leaves(step[1]["grads"])
    assert all(np.abs(g).max() > 0 for g in grads.values())
    _check("grads", lambda r: 2e-4 * np.abs(r).max() + 1e-6, step)


def test_ptv3_head_bn_statistics_match_jax(step):
    """The one BatchNorm of the family: its running variance takes the
    biased batch variance, as flax does."""
    assert set(step[1]["batch_stats"]) == {"head_bn"}
    _check("batch_stats", lambda r: 1e-5 * np.abs(r).max(), step)


def test_ptv3_sgd_step_matches_jax(step):
    _check("sgd_params", lambda r: 1e-6, step)


# ------------------------------------------------------------------ dropout


def _seed_dropouts(model, seed):
    gen = torch.Generator().manual_seed(seed)
    count = 0
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = gen
            count += 1
    return count


@pytest.mark.parametrize("name,kwargs,per_block", [
    ("ptv3", dict(FLAT, window_size=64), 2), ("ptv3_pooled", POOLED, 2)])
def test_dropout_in_train_mode_follows_the_generator(rng, name, kwargs, per_block):
    """With drop_rate > 0 the train-mode forward differs between two seeds of
    the Dropouts' generator and repeats for one; eval mode ignores it."""
    model = get_model(name, 5, generator=torch.Generator().manual_seed(0), drop_rate=0.3,
                      head_drop_rate=0.5, **kwargs)
    xyz = _t(rng.uniform(-1.0, 1.0, size=(2, 256, 3)).astype(np.float32))
    rgb = _t(rng.uniform(size=(2, 256, 3)).astype(np.float32))
    blocks = sum(1 for m in model.modules() if isinstance(m, PointTransformerBlock))
    outs = []
    for seed in (1, 1, 2):
        # a block's proj_drop and its feed-forward's drop (used twice), and the head's
        assert _seed_dropouts(model, seed) == per_block * blocks + 1
        model.train()
        with torch.no_grad():
            outs.append(model(xyz, rgb))
    assert torch.equal(outs[0], outs[1])
    assert not torch.allclose(outs[0], outs[2], atol=1e-3)
    model.eval()
    with torch.no_grad():
        assert torch.equal(model(xyz, rgb), model(xyz, rgb))


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_keeps_its_share_and_rescales(p):
    drop = Dropout(p).train()
    drop.generator = torch.Generator().manual_seed(3)
    n = 200_000
    out = drop(torch.ones(n))
    kept = (out != 0).double().mean().item()
    # four standard deviations of a binomial share
    assert abs(kept - (1 - p)) <= 4 * np.sqrt(p * (1 - p) / n)
    np.testing.assert_allclose(out[out != 0].numpy(), 1.0 / (1.0 - p), rtol=1e-6)
    assert torch.equal(drop.eval()(torch.ones(8)), torch.ones(8))


# --------------------------------------------------------------- the CLIs


def _write_scenes(tmp_path):
    for sub, seed in (("train", 0), ("val", 1)):
        d = tmp_path / sub
        d.mkdir()
        xyz, rgb, labels = toy_bridge_scene(6000, seed=seed)
        write_las(str(d / f"scene{seed}.las"), xyz, rgb, labels)


def test_train_cli_trains_ptv3_pooled_and_infer_cli_serves_it(tmp_path, monkeypatch, capsys):
    """The registry's default ptv3_pooled at a tiny block size: one epoch
    through train_cli, every Dropout seeded by the trainer, a resumed second
    epoch, and infer_cli serving the best_model that the run wrote."""
    _write_scenes(tmp_path)
    monkeypatch.chdir(tmp_path)  # exp_dir_root is relative
    argv = ["--train-dir", str(tmp_path / "train"), "--val-dir", str(tmp_path / "val"),
            "--model", "ptv3_pooled", "--num-points", "128", "--batch-size", "4",
            "--sampler", "random", "--device", "cpu", "--case", "pooled"]
    out = train_cli.main(argv + ["--num-epochs", "1"])
    exp = out["exp_dir"]
    assert exp.endswith("_pooled") and [r["epoch"] for r in out["history"]] == [1]
    assert np.isfinite(out["history"][0]["train_loss"])
    assert np.isfinite(out["history"][0]["val_loss"])
    gens = {id(m.generator) for m in out["model"].modules() if isinstance(m, Dropout)}
    assert len(gens) == 1 and None not in {m.generator for m in out["model"].modules()
                                           if isinstance(m, Dropout)}
    for name in ("best_model", "latest_checkpoint"):
        assert os.path.exists(os.path.join(exp, name)), name
    first = restore_checkpoint(os.path.join(exp, "latest_checkpoint"))
    assert first["epoch"] == 1

    # resume: the epoch counter continues and the weights move on
    cfg = Config()
    cfg.device = "cpu"
    cfg.model.name = "ptv3_pooled"
    cfg.data.train_dir, cfg.data.val_dir = str(tmp_path / "train"), str(tmp_path / "val")
    cfg.data.num_points, cfg.data.sampler = 128, "random"
    cfg.train.batch_size, cfg.train.num_epochs = 4, 2
    tr, va = train_cli.build_datasets(cfg)
    out2 = train(cfg, tr, va, exp_dir=exp, resume=True)
    assert [r["epoch"] for r in out2["history"]] == [2]
    latest = restore_checkpoint(os.path.join(exp, "latest_checkpoint"))
    assert latest["epoch"] == 2
    assert not torch.equal(latest["model"]["head_fc2.weight"], first["model"]["head_fc2.weight"])

    capsys.readouterr()
    infer_cli.main(["blocks", "--checkpoint", exp, "--model", "ptv3_pooled",
                    "--data-dir", str(tmp_path / "val"), "--out-dir", str(tmp_path / "served"),
                    "--num-points", "128", "--batch-size", "4", "--device", "cpu"])
    assert "GLOBAL mIoU=" in capsys.readouterr().out
    cm = np.loadtxt(tmp_path / "served" / "confusion_matrix.csv", delimiter=",")
    assert cm.shape == (5, 5) and cm.sum() > 0 and cm.sum() % 128 == 0


def test_train_cli_takes_the_model_from_a_config(tmp_path, monkeypatch):
    """``--config`` with ``model_extra``, as configs/train_ptv3_pooled.yaml
    and train_ptv3.yaml give it, the data directories and epochs as flags."""
    _write_scenes(tmp_path)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "tiny.yaml").write_text(
        "case: TINY\nmodel: ptv3\nnum_classes: 5\nnum_points: 128\nbatch_size: 4\n"
        "num_epochs: 100\nlearning_rate: 0.001\ntrain_dir: data/train\nval_dir: data/val\n"
        "model_extra: {embed_dim: 32, depth: 2, num_heads: 2, window_size: 64}\n"
        "loss: {name: weighted_ce, use_class_weights: true}\ntrain: {scheduler: plateau}\n")
    out = train_cli.main(["--config", str(tmp_path / "tiny.yaml"),
                          "--train-dir", str(tmp_path / "train"),
                          "--val-dir", str(tmp_path / "val"), "--num-epochs", "1",
                          "--sampler", "random", "--device", "cpu"])
    model = out["model"]
    assert model.depth == 2 and model.window_size == 64
    assert model.block1.attn.qkv.weight.shape == (96, 32)
    assert np.isfinite(out["history"][0]["train_loss"])


@pytest.mark.parametrize("config,kwargs", [
    ("train_ptv3_pooled.yaml", dict(enc_depths=(2, 2, 6), window_size=1024)),
    ("train_ptv3.yaml", dict(depth=8)),
])
def test_the_family_configs_build_their_models(config, kwargs):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = Config.from_yaml(os.path.join(repo, "configs", config))
    assert cfg.loss.name == "weighted_ce" and cfg.train.batch_size == 16
    model = get_model(cfg.model.name, cfg.model.num_classes, **cfg.model.extra)
    for key, value in kwargs.items():
        assert getattr(model, key) == value, key


def test_remat_in_a_config_goes_on_raising_by_name():
    """configs/train_ptv3_big_prod.yaml's model_extra builds: 12 blocks of 6
    heads over 384 channels, a bfloat16 stream and remat, float32
    parameters; its train section asks for 4 microbatches a step."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = Config.from_yaml(os.path.join(repo, "configs", "train_ptv3_big_prod.yaml"))
    assert cfg.model.extra["remat"] is True and cfg.train.accum_steps == 4
    model = get_model(cfg.model.name, cfg.model.num_classes, **cfg.model.extra)
    assert model.remat and model.stream_dtype == torch.bfloat16 and model.depth == 12
    assert model.block11.attn.num_heads == 6 and model.block11.norm1.out_dtype == torch.bfloat16
    assert model.block0.attn.qkv.dtype == torch.bfloat16 and model.patch_embed.dtype is None
    assert all(p.dtype == torch.float32 for p in model.parameters())
