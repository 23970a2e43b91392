"""The PyTorch port's ``pointnet2_msg`` train step against the JAX package,
and configs/train_partsize_msg.yaml through the port's CLIs, on the CPU.

One train-mode step of the JAX package and of the port, on the same seeded
inputs and weights (``flax_to_state_dict`` of a seeded port model's
variables, every parameter perturbed and every BatchNorm moved away from
the identity; tests/test_torch_bristrunet.py ``randomize``), with the
recipe's ``sol`` loss as both trainers apply it, dropout 0.

Bands, with the method of tests/test_torch_bristrunet_train.py and
tests/test_torch_dgcnn_train.py: each quantity is held to the JAX float64
step within a base tolerance (logits 2e-4, gradients 2e-4 * max|g| + 1e-6,
BatchNorm statistics 1e-5 * max|stat|, SGD parameters 1e-6) plus twice the
JAX package's own float32 error on that leaf; the loss within 1e-5
relative plus twice that error. The float64 step is float64 but where the
JAX model itself casts to float32: the coarse features before each
interpolation (models/common.py FeaturePropagation) and the head's last
Dense (SegHead), so it carries float32 rounding there, as the port does. The biases in front of a train-mode
BatchNorm (every conv of the model but the head's last) have a gradient
that is exactly 0: they are held structurally, not leaf by leaf, as
chip_smoke.py holds them on the card: both sides keep them below
1e-4 * max|g| of the same layer's weight. (Leaf by leaf the port's float32
noise on them reaches 1.3e-5 where twice the JAX float32 step's is 1.1e-5,
against weight gradients a thousand times larger.)
"""

import torch_cpu  # noqa: F401  (first: torch's threads a worker)

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
from pointcloud_bridge_tpu_torch.models import PointNet2MSG, get_model
from pointcloud_bridge_tpu_torch.train import make_train_step
from pointcloud_bridge_tpu_torch.utils.weights import (
    MODEL_RULES,
    flax_to_state_dict,
    state_dict_to_flax,
)

from test_torch_bristrunet import randomize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(REPO, "configs", "train_partsize_msg.yaml")
SGD_LR = 0.1
MODULES = ["sa1", "sa2", "sa3", "sa4", "fp4", "fp3", "fp2", "fp1", "head"]
# the flax layers whose output is no BatchNorm's input: the head's last
NOT_PRE_BN = {"conv2"}


def _t(a):
    return torch.from_numpy(np.array(a))


def _batch():
    """Two blocks of 1280 points (sa1 takes 1024 centres), colours, and
    labels whose classes sit in z order (abutment < girder < deck <
    parapet), as the ``sol`` loss's hierarchy expects of a bridge."""
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-1.0, 1.0, size=(2, 1280, 3)).astype(np.float32)
    labels = np.clip(((xyz[..., 2] + 1.0) * 2.0).astype(np.int32), 0, 3)
    labels[:, ::17] = 4  # noise anywhere
    return {"points": xyz, "colors": rng.uniform(size=(2, 1280, 3)).astype(np.float32),
            "labels": labels}


def _jax_step(variables, b, dtype):
    """Loss, train-mode logits, gradients, updated batch_stats and one
    plain-SGD step's parameters (params - lr * g) of the JAX package,
    computing in ``dtype``."""
    jmodel = jax_get_model("pointnet2_msg", 5, dropout_rate=0.0)
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), variables)
    b = {k: (np.asarray(x, dtype) if x.dtype == np.float32 else x) for k, x in b.items()}

    def loss_fn(params, stats, x, c, lbl):
        logits, mut = jmodel.apply(
            {"params": params, "batch_stats": stats}, x, c, train=True,
            mutable=["batch_stats"],
        )
        return JL.sol_loss(logits, lbl, x), (logits, mut["batch_stats"])

    (loss, (logits, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"], v["batch_stats"], b["points"], b["colors"], b["labels"]
    )
    out = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), {
        "loss": loss, "logits": logits, "grads": grads, "batch_stats": stats})
    out["sgd_params"] = jax.tree_util.tree_map(
        lambda p, g: np.asarray(p, np.float64) - SGD_LR * g, v["params"], out["grads"])
    return out


@pytest.fixture(scope="module")
def step():
    """(JAX float32, JAX float64, port) results of one train step."""
    b = _batch()
    seeded = get_model("pointnet2_msg", 5, generator=torch.Generator().manual_seed(0))
    variables = randomize(state_dict_to_flax(seeded.state_dict(), "pointnet2_msg"))
    want32 = _jax_step(variables, b, np.float32)
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        want64 = _jax_step(variables, b, np.float64)
    finally:
        jax.config.update("jax_enable_x64", x64)

    def port_model():
        model = get_model("pointnet2_msg", 5, dropout_rate=0.0)
        model.load_state_dict(flax_to_state_dict(variables, "pointnet2_msg"), strict=True)
        return model

    tb = {"points": _t(b["points"]), "colors": _t(b["colors"]), "labels": _t(b["labels"]).long()}
    model = port_model().train()
    logits = model(tb["points"], tb["colors"])
    loss = losses.sol_loss(logits, tb["labels"], tb["points"])
    loss.backward()
    sgd_model = port_model()
    # the class weights a train step is handed go unused by this loss
    metrics = make_train_step(sgd_model, Config.from_yaml(RECIPE).loss, torch.optim.SGD(
        sgd_model.parameters(), lr=SGD_LR))(tb, SGD_LR, torch.ones(5))
    to64 = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), t)  # noqa: E731
    grads = {k: p.grad for k, p in model.named_parameters()}
    return want32, want64, {
        "loss": float(loss.detach()),
        "sgd_loss": float(metrics["loss"]),
        "logits": logits.detach().double().numpy(),
        "grads": to64(state_dict_to_flax(grads, "pointnet2_msg")["params"]),
        "batch_stats": to64(state_dict_to_flax(model.state_dict(),
                                               "pointnet2_msg")["batch_stats"]),
        "sgd_params": to64(state_dict_to_flax(sgd_model.state_dict(),
                                              "pointnet2_msg")["params"]),
        "torch_grads": grads,
    }


def _pre_bn_bias(module, path) -> bool:
    """A flax leaf that is the bias of a Dense in front of a BatchNorm:
    every Dense of the model but the head's last (``dense1``)."""
    keys = [module] + [str(getattr(p, "key", p)) for p in path]
    return keys[-1] == "bias" and keys[-2].startswith("dense") and keys[-2] != "dense1"


def _check(key, module, base, step, skip_pre_bn=False):
    """Per leaf: |port - ref64| <= base(ref64) + 2 |jax32 - ref64|. With
    ``skip_pre_bn`` the biases in front of a BatchNorm are left out: their
    gradient is exactly 0, every float32 value of it rounding noise, and
    test_every_parameter_gets_a_gradient holds them."""
    want32, want64, got = step
    pick = (lambda t: t[key][module]) if module else (lambda t: {"": t[key]})
    ref = [(path, r) for path, r in jax.tree_util.tree_leaves_with_path(pick(want64))
           if not (skip_pre_bn and _pre_bn_bias(module, path))]
    j32 = dict(jax.tree_util.tree_leaves_with_path(pick(want32)))
    port = dict(jax.tree_util.tree_leaves_with_path(pick(got)))
    assert len(j32) == len(port) >= len(ref) > 0
    for path, r in ref:
        assert port[path].shape == r.shape, path
        err = np.abs(port[path] - r).max()
        tol = base(r) + 2 * np.abs(j32[path] - r).max()
        assert err <= tol, (f"{key} {module}{jax.tree_util.keystr(path)}: "
                            f"|port - f64| {err:.3g} > {tol:.3g}")


def test_train_loss_matches_jax(step):
    want32, want64, got = step
    tol = 1e-5 * abs(want64["loss"]) + 2 * abs(want32["loss"] - want64["loss"])
    for key in ("loss", "sgd_loss"):
        assert abs(got[key] - want64["loss"]) <= tol, (key, got[key], want64["loss"], tol)


def test_train_mode_logits_match_jax(step):
    assert step[2]["logits"].shape == (2, 1280, 5)
    _check("logits", None, lambda r: 2e-4, step)


@pytest.mark.parametrize("module", MODULES)
def test_gradients_match_jax(step, module):
    _check("grads", module, lambda r: 2e-4 * np.abs(r).max() + 1e-6, step, skip_pre_bn=True)


@pytest.mark.parametrize("module", MODULES)
def test_batch_stats_match_jax(step, module):
    _check("batch_stats", module, lambda r: 1e-5 * np.abs(r).max(), step)


@pytest.mark.parametrize("module", MODULES)
def test_sgd_step_matches_jax(step, module):
    _check("sgd_params", module, lambda r: 1e-6, step)


def test_every_parameter_gets_a_gradient(step):
    """Every parameter reaches the loss, sa1's through the group kernel's
    gradient-free inputs too: present, finite, non-zero, except the biases
    in front of a BatchNorm, whose gradient is exactly 0 and stays below
    1e-4 * max|g| of the layer's weight in both packages."""
    want32, _, got = step
    grads = got["torch_grads"]
    jgrads = dict(zip(*zip(*[(tp, fp) for tp, fp, _ in MODEL_RULES["pointnet2_msg"]()])))
    pre_bn = 0
    for key, g in grads.items():
        assert g is not None and torch.isfinite(g).all(), key
        layer = key.rsplit(".", 1)[0]
        if key.endswith(".bias") and layer + ".weight" in grads and layer not in NOT_PRE_BN \
                and g.dim() == 1 and "bn" not in layer:
            pre_bn += 1
            bound = 1e-4 * grads[layer + ".weight"].abs().max().item()
            jleaf = want32["grads"]
            for part in jgrads[layer]:
                jleaf = jleaf[part]
            assert np.abs(jleaf["bias"]).max() <= 1e-4 * np.abs(jleaf["kernel"]).max(), key
            assert g.abs().max().item() <= bound, key
        else:
            assert g.abs().max() > 0, key
    assert pre_bn == 2 * 3 * 4 + 9 + 1  # the SA branches, the FP convs, conv1


def test_the_recipe_in_the_step_is_the_sol_loss():
    cfg = Config.from_yaml(RECIPE)
    assert cfg.loss.name == "sol"
    assert isinstance(get_model(cfg.model.name, cfg.model.num_classes), PointNet2MSG)


# ------------------------------------------------------ the recipe, end to end


def test_the_recipe_trains_through_train_cli_and_infer_cli_serves_it(tmp_path, monkeypatch,
                                                                     capsys):
    """configs/train_partsize_msg.yaml as a user runs it (pointnet2_msg, the
    ``sol`` loss, step decay 0.7 every 10 epochs), with the data
    directories, a small block and one epoch as flags, on the CPU; then
    ``infer_cli blocks --model pointnet2_msg`` serves the checkpoint."""
    for sub, seed in (("train", 0), ("val", 1)):
        d = tmp_path / sub
        d.mkdir()
        xyz, rgb, labels = toy_bridge_scene(3000, seed=seed)
        write_las(str(d / f"scene{seed}.las"), xyz, rgb, labels)
    monkeypatch.chdir(tmp_path)  # exp_dir_root is relative
    recipe = os.path.join(REPO, "configs", "train_partsize_msg.yaml")
    cfg = Config.from_yaml(recipe)
    assert (cfg.model.name, cfg.loss.name, cfg.train.batch_size, cfg.data.num_points,
            cfg.train.scheduler, cfg.train.step_decay, cfg.train.step_every) == (
        "pointnet2_msg", "sol", 16, 4096, "step", 0.7, 10)
    out = train_cli.main([
        "--config", recipe, "--train-dir", str(tmp_path / "train"),
        "--val-dir", str(tmp_path / "val"), "--num-points", "128", "--batch-size", "4",
        "--num-epochs", "1", "--device", "cpu"])
    exp = out["exp_dir"]
    assert isinstance(out["model"], PointNet2MSG)
    assert [r["epoch"] for r in out["history"]] == [1]
    row = out["history"][0]
    assert np.isfinite(row["train_loss"]) and np.isfinite(row["val_loss"])
    assert row["lr"] == pytest.approx(1e-3)
    for name in ("best_model", "latest_checkpoint"):
        assert os.path.exists(os.path.join(exp, name)), name
    capsys.readouterr()
    infer_cli.main(["blocks", "--checkpoint", exp, "--model", "pointnet2_msg",
                    "--data-dir", str(tmp_path / "val"), "--out-dir", str(tmp_path / "served"),
                    "--num-points", "128", "--batch-size", "4", "--device", "cpu"])
    assert "GLOBAL mIoU=" in capsys.readouterr().out
    cm = np.loadtxt(tmp_path / "served" / "confusion_matrix.csv", delimiter=",")
    assert cm.shape == (5, 5) and cm.sum() > 0 and cm.sum() % 128 == 0
