"""The PyTorch port's BriStruNet train step against the JAX package, and the
BriStruNet recipe (configs/train_bristrunet.yaml) through the port's CLIs,
on the CPU.

One train-mode step of the JAX package and of the port, on the same seeded
inputs and weights (``flax_to_state_dict``, every parameter perturbed and
every BatchNorm moved away from the identity), with the recipe's loss as
both trainers apply it: ``bridge_structure`` with alpha 80 and rel_margin
0.3, whose class weights are its base weights (1.5, 1, 1.2, 1.5, 1) raised
by the hierarchy's violations and scaled by inverse-sqrt label frequencies;
dropout 0.

Bands, with the method of tests/test_torch_train.py. BriStruNet has some
forty train-mode BatchNorms, which amplify float32 rounding: the JAX
package's own float32 step is a median 1.7% of max|g| (up to several per
cent) from the same step computed in float64, and the port's float32 step
moves by up to 5% of max|g| when its input colours change by one ulp. So no
float32 gradient can be held to 2e-4 * max|g| of another. The JAX package's
one-ulp colour spread is no band here either: measured on this step it is
about 2e-5 of max|g|, far below its own float32-to-float64 gap. A float64
step can be had without editing the JAX package: under ``jax_enable_x64``
with float64 weights and inputs every module computes in float64, except
the structure encodings' eigen-solve, which ops/structure.py:80,136 casts to
float32; those features are functions of the input coordinates alone, so
they enter as float32-rounded inputs. Each quantity is held to that float64
step: within the base tolerance (logits 2e-4, gradients 2e-4 * max|g| +
1e-6, BatchNorm statistics 1e-5 * max|stat|, SGD parameters 1e-6) plus twice
the JAX package's own float32 error on that leaf. The loss agrees with both
JAX steps within 1e-5 relative. The biases in front of a train-mode
BatchNorm have a gradient that is exactly 0 (the batch mean takes them out
again): both sides must keep them below 1e-4 * max|g| of the same layer's
weight. A plain-SGD step through the port's ``make_train_step`` is held to
params - lr * g of each JAX step in the same way.
"""

import os

import jax
import numpy as np
import pytest
import torch

from pointcloud_bridge_tpu import losses as JL
from pointcloud_bridge_tpu.data import write_las
from pointcloud_bridge_tpu.data.synthetic import toy_bridge_scene
from pointcloud_bridge_tpu.models import get_model as jax_get_model
from pointcloud_bridge_tpu_torch import infer_cli, losses, train_cli
from pointcloud_bridge_tpu_torch.config import Config
from pointcloud_bridge_tpu_torch.models import BatchNorm, Dense, get_model
from pointcloud_bridge_tpu_torch.train import make_train_step
from pointcloud_bridge_tpu_torch.utils.weights import flax_to_state_dict, state_dict_to_flax

from test_torch_bristrunet import randomize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SA_NPOINTS = (64, 32, 16)
ALPHA, REL_MARGIN = 80.0, 0.3
SGD_LR = 0.1
MODULES = ["bri_enc", "color_encoder", "feature_fusion", "sa1", "sa2", "geometric2", "sa3",
           "geometric3", "fp3", "fp2", "fp1", "fusion", "final0", "final_bn", "final1"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _batch():
    rng = np.random.default_rng(0)
    return {
        "points": rng.uniform(-1.0, 1.0, size=(2, 256, 3)).astype(np.float32),
        "colors": rng.uniform(size=(2, 256, 3)).astype(np.float32),
        "labels": rng.integers(0, 5, size=(2, 256)).astype(np.int32),
    }


def _recipe_loss():
    """The loss section of configs/train_bristrunet.yaml."""
    cfg = Config().loss
    cfg.name, cfg.alpha, cfg.rel_margin = "bridge_structure", ALPHA, REL_MARGIN
    return cfg


def _jax_step(variables, b, dtype):
    """Loss, train-mode logits, gradients, updated batch_stats and one
    plain-SGD step's parameters (params - lr * g) of the JAX package,
    computing in ``dtype`` (the modules take the type of their weights and
    inputs); the loss is the one pointcloud_bridge_tpu/train/loop.py applies
    for the recipe."""
    jmodel = jax_get_model("bristrunet", 5, sa_npoints=SA_NPOINTS, dropout_rate=0.0)
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), variables)
    b = {k: (np.asarray(x, dtype) if x.dtype == np.float32 else x) for k, x in b.items()}

    def loss_fn(params, stats, x, c, lbl):
        logits, mut = jmodel.apply(
            {"params": params, "batch_stats": stats}, x, c, train=True,
            mutable=["batch_stats"],
        )
        loss = JL.bridge_structure_loss(logits, lbl, x, alpha=ALPHA, rel_margin=REL_MARGIN)
        return loss, (logits, mut["batch_stats"])

    (loss, (logits, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"], v["batch_stats"], b["points"], b["colors"], b["labels"]
    )
    assert logits.dtype == dtype
    out = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), {
        "loss": loss, "logits": logits, "grads": grads, "batch_stats": stats})
    out["sgd_params"] = jax.tree_util.tree_map(
        lambda p, g: np.asarray(p, np.float64) - SGD_LR * g, v["params"], out["grads"])
    return out


def pre_bn_layers(model, xyz, rgb) -> set:
    """The Dense layers whose output goes straight into a BatchNorm, found
    by running the model once with hooks."""
    made, fed = {}, set()
    hooks = []
    for name, m in model.named_modules():
        if isinstance(m, Dense):
            hooks.append(m.register_forward_hook(
                lambda mod, inp, out, name=name: made.__setitem__(id(out), name)))
        elif isinstance(m, BatchNorm):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, inp: fed.add(made.get(id(inp[0])))))
    with torch.no_grad():
        model(xyz, rgb)
    for h in hooks:
        h.remove()
    return fed - {None}


@pytest.fixture(scope="module")
def step():
    """(JAX float32, JAX float64, port) results of one train step."""
    b = _batch()
    # the flax variables of a seeded port model (the rule table's round trip
    # is exact and complete, tests/test_torch_bristrunet.py), perturbed
    seeded = get_model("bristrunet", 5, sa_npoints=SA_NPOINTS,
                       generator=torch.Generator().manual_seed(0))
    variables = randomize(state_dict_to_flax(seeded.state_dict(), "bristrunet"))
    want32 = _jax_step(variables, b, np.float32)
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        want64 = _jax_step(variables, b, np.float64)
    finally:
        jax.config.update("jax_enable_x64", x64)

    def port_model():
        model = get_model("bristrunet", 5, sa_npoints=SA_NPOINTS, dropout_rate=0.0)
        model.load_state_dict(flax_to_state_dict(variables, "bristrunet"), strict=True)
        return model

    tb = {"points": _t(b["points"]), "colors": _t(b["colors"]), "labels": _t(b["labels"]).long()}
    model = port_model().train()
    logits = model(tb["points"], tb["colors"])
    loss = losses.bridge_structure_loss(logits, tb["labels"], tb["points"], alpha=ALPHA,
                                        rel_margin=REL_MARGIN)
    loss.backward()
    sgd_model = port_model()
    # the class weights a train step is handed go unused by this loss
    metrics = make_train_step(sgd_model, _recipe_loss(), torch.optim.SGD(
        sgd_model.parameters(), lr=SGD_LR))(tb, SGD_LR, torch.ones(5))
    to64 = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), t)  # noqa: E731
    grads = {k: p.grad for k, p in model.named_parameters()}
    pre_bn = pre_bn_layers(port_model().train(), tb["points"], tb["colors"])
    got = {
        "loss": float(loss.detach()),
        "sgd_loss": float(metrics["loss"]),
        "logits": logits.detach().double().numpy(),
        "grads": to64(state_dict_to_flax(grads, "bristrunet")["params"]),
        "batch_stats": to64(state_dict_to_flax(model.state_dict(), "bristrunet")["batch_stats"]),
        "sgd_params": to64(state_dict_to_flax(sgd_model.state_dict(), "bristrunet")["params"]),
        "torch_grads": grads,
        "pre_bn": pre_bn,
    }
    return want32, want64, got


def _check(key, module, base, step):
    """Per leaf: |port - ref64| <= base(ref64) + 2 |jax32 - ref64|."""
    want32, want64, got = step
    pick = (lambda t: t[key][module]) if module else (lambda t: {"": t[key]})
    ref = jax.tree_util.tree_leaves_with_path(pick(want64))
    j32 = dict(jax.tree_util.tree_leaves_with_path(pick(want32)))
    port = dict(jax.tree_util.tree_leaves_with_path(pick(got)))
    assert len(ref) == len(j32) == len(port) > 0
    for path, r in ref:
        assert port[path].shape == r.shape, path
        err = np.abs(port[path] - r).max()
        tol = base(r) + 2 * np.abs(j32[path] - r).max()
        assert err <= tol, (f"{key} {module}{jax.tree_util.keystr(path)}: "
                            f"|port - f64| {err:.3g} > {tol:.3g}")


def test_train_loss_matches_jax(step):
    want32, want64, got = step
    for want in (want32, want64):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["sgd_loss"], want32["loss"], rtol=1e-5)


def test_train_mode_logits_match_jax(step):
    assert step[2]["logits"].shape == (2, 256, 5)
    _check("logits", None, lambda r: 2e-4, step)


@pytest.mark.parametrize("module", MODULES)
def test_gradients_match_jax(step, module):
    _check("grads", module, lambda r: 2e-4 * np.abs(r).max() + 1e-6, step)


@pytest.mark.parametrize("module", [m for m in MODULES if m not in ("final0", "final1")])
def test_batch_stats_match_jax(step, module):
    """The running variance takes the biased batch variance, as flax does."""
    _check("batch_stats", module, lambda r: 1e-5 * np.abs(r).max(), step)


@pytest.mark.parametrize("module", MODULES)
def test_sgd_step_matches_jax(step, module):
    _check("sgd_params", module, lambda r: 1e-6, step)


def test_every_parameter_gets_a_gradient(step):
    """Every parameter reaches the loss (through the group, interpolation and
    k-NN Functions among others): present, finite, and non-zero except the
    biases in front of a BatchNorm, whose gradient is exactly 0 and stays
    below 1e-4 * max|g| of the layer's weight in both packages."""
    want32, _, got = step
    grads, pre_bn = got["torch_grads"], got["pre_bn"]
    assert len(pre_bn) >= 30 and "final0" in pre_bn and "sa1.mlp_0.dense_0" in pre_bn
    jgrads = {".".join(str(p.key) for p in path): np.asarray(v) for path, v in
              jax.tree_util.tree_leaves_with_path(want32["grads"])}
    for name, g in grads.items():
        assert g is not None and torch.isfinite(g).all(), name
        layer = name.rsplit(".", 1)[0]
        if name.endswith(".bias") and layer in pre_bn:
            bound = 1e-4 * grads[layer + ".weight"].abs().max().item()
            jbias = jgrads[".".join(layer.split(".")) + ".bias"]
            assert g.abs().max().item() <= bound and np.abs(jbias).max() <= bound, name
        else:
            assert g.abs().max() > 0, name


# ------------------------------------------------------ the recipe, end to end


def test_the_recipe_trains_through_train_cli_and_infer_cli_serves_it(tmp_path, monkeypatch,
                                                                     capsys):
    """configs/train_bristrunet.yaml as a user runs it (bridge_structure
    loss, weighted block sampling, the plateau scheduler, Adam), with the
    data directories, a small block and one epoch as flags, on the CPU; then
    ``infer_cli blocks`` serves the checkpoint it wrote."""
    for sub, seed in (("train", 0), ("val", 1)):
        d = tmp_path / sub
        d.mkdir()
        xyz, rgb, labels = toy_bridge_scene(3000, seed=seed)
        write_las(str(d / f"scene{seed}.las"), xyz, rgb, labels)
    monkeypatch.chdir(tmp_path)  # exp_dir_root is relative
    recipe = Config.from_yaml(os.path.join(REPO, "configs", "train_bristrunet.yaml"))
    assert (recipe.model.name, recipe.loss.name, recipe.loss.alpha, recipe.loss.rel_margin,
            recipe.data.weighted_sampling, recipe.train.scheduler) == (
        "bristrunet", "bridge_structure", 80.0, 0.3, True, "plateau")
    out = train_cli.main([
        "--config", os.path.join(REPO, "configs", "train_bristrunet.yaml"),
        "--train-dir", str(tmp_path / "train"), "--val-dir", str(tmp_path / "val"),
        "--num-points", "128", "--batch-size", "4", "--num-epochs", "1", "--device", "cpu"])
    exp = out["exp_dir"]
    assert exp.endswith("_CBdata_BriStruNet") and [r["epoch"] for r in out["history"]] == [1]
    row = out["history"][0]
    assert np.isfinite(row["train_loss"]) and np.isfinite(row["val_loss"])
    for name in ("best_model", "latest_checkpoint"):
        assert os.path.exists(os.path.join(exp, name)), name
    capsys.readouterr()
    infer_cli.main(["blocks", "--checkpoint", exp, "--model", "bristrunet",
                    "--data-dir", str(tmp_path / "val"), "--out-dir", str(tmp_path / "served"),
                    "--num-points", "128", "--batch-size", "4", "--device", "cpu"])
    assert "GLOBAL mIoU=" in capsys.readouterr().out
    cm = np.loadtxt(tmp_path / "served" / "confusion_matrix.csv", delimiter=",")
    assert cm.shape == (5, 5) and cm.sum() > 0 and cm.sum() % 128 == 0
