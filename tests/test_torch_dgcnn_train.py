"""The PyTorch port's DGCNN and DGCNNGlobal train steps against the JAX
package, and configs/train_dgcnn.yaml through the port's CLIs, on the CPU.

One train-mode step of the JAX package and of the port, on the same seeded
inputs and weights (``flax_to_state_dict``, every parameter perturbed and
every BatchNorm moved away from the identity), with weighted cross-entropy
as both trainers apply it by default; dropout 0 for ``dgcnn_global``.

Graphs: the JAX float32 step records each EdgeConv's graph
(tests/test_torch_dgcnn.py ``JaxGraphs``), and the JAX float64 step and the
port's step replay them, so that the three compute on the same graphs (a
pick that swaps at a near tie would move a point's max by O(1) and say
nothing about the port). The port's own graphs are held to the tie band in
tests/test_torch_dgcnn.py.

Bands, with the method of tests/test_torch_train.py and
tests/test_torch_bristrunet_train.py: each quantity is held to the JAX
float64 step within a base tolerance (logits 2e-4, gradients 2e-4 * max|g|
+ 1e-6, BatchNorm statistics 1e-5 * max|stat|, SGD parameters 1e-6) plus
twice the JAX package's own float32 error on that leaf, the loss within
1e-5 relative plus twice that error. The biases in front of a train-mode
BatchNorm (``point_conv.0`` and ``.3`` of DGCNN, ``linear2`` of DGCNNGlobal)
have a gradient that is exactly 0, and so has DGCNN's ``bn5.bias``, whose
shift reaches point_conv.1's batch mean through the max over the points:
both sides keep them below 1e-4 * max|g| of the same layer's weight.
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
from pointcloud_bridge_tpu_torch import infer_cli, losses, train_cli
from pointcloud_bridge_tpu_torch.config import Config
from pointcloud_bridge_tpu_torch.models import BatchNorm, get_model
from pointcloud_bridge_tpu_torch.train import make_train_step
from pointcloud_bridge_tpu_torch.utils.weights import flax_to_state_dict, state_dict_to_flax

from test_torch_bristrunet import randomize
from test_torch_dgcnn import JaxGraphs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 16
CLASS_WEIGHTS = np.array([0.7, 1.3, 2.0, 0.5, 1.1], np.float32)
SGD_LR = 0.1
EDGE = ["conv1", "conv2", "conv3", "conv4", "conv5", "bn5"]
MODULES = {
    "dgcnn": EDGE + ["local_bn", "point_conv1", "bn_p1", "point_conv2", "bn_p2", "point_conv3"],
    "dgcnn_global": EDGE + ["linear1", "bn6", "linear2", "bn7", "linear3"],
}
# port layer -> flax module of the biases whose gradient is exactly 0: those
# that feed a BatchNorm, and DGCNN's bn5, whose shift moves every point's
# conv5 feature alike, passes the max over the points with slope 1 and is
# taken out again by point_conv.1's batch mean (the JAX float64 step gives
# it 2e-15 of bn5.weight's gradient)
PRE_BN = {"dgcnn": {"point_conv.0": "point_conv1", "point_conv.3": "point_conv2",
                    "bn5": "bn5"},
          "dgcnn_global": {"linear2": "linear2"}}
STATS = {"dgcnn": ["conv1", "conv2", "conv3", "conv4", "bn5", "local_bn", "bn_p1", "bn_p2"],
         "dgcnn_global": ["conv1", "conv2", "conv3", "conv4", "bn5", "bn6", "bn7"]}
KWARGS = {"dgcnn": {"k": K}, "dgcnn_global": {"k": K, "dropout_rate": 0.0}}
CASES = [(name, m) for name in MODULES for m in MODULES[name]]


def _t(a):
    return torch.from_numpy(np.array(a))


def _batch():
    rng = np.random.default_rng(0)
    return {
        "points": rng.uniform(-1.0, 1.0, size=(2, 128, 3)).astype(np.float32),
        "colors": rng.uniform(size=(2, 128, 3)).astype(np.float32),
        "labels": rng.integers(0, 5, size=(2, 128)).astype(np.int32),
    }


def _jax_step(name, variables, b, dtype):
    """Loss, train-mode logits, gradients, updated batch_stats and one
    plain-SGD step's parameters (params - lr * g) of the JAX package,
    computing in ``dtype``."""
    jmodel = jax_get_model(name, 5, **KWARGS[name])
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
    out = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), {
        "loss": loss, "logits": logits, "grads": grads, "batch_stats": stats})
    out["sgd_params"] = jax.tree_util.tree_map(
        lambda p, g: np.asarray(p, np.float64) - SGD_LR * g, v["params"], out["grads"])
    return out


def _step(name, monkeypatch):
    """(JAX float32, JAX float64, port) results of one train step."""
    b = _batch()
    seeded = get_model(name, 5, generator=torch.Generator().manual_seed(0), **KWARGS[name])
    variables = randomize(state_dict_to_flax(seeded.state_dict(), name))
    graphs = JaxGraphs(monkeypatch)
    graphs.record()
    want32 = _jax_step(name, variables, b, np.float32)
    graphs.replay()
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        want64 = _jax_step(name, variables, b, np.float64)
    finally:
        jax.config.update("jax_enable_x64", x64)

    def port_model():
        model = get_model(name, 5, **KWARGS[name])
        model.load_state_dict(flax_to_state_dict(variables, name), strict=True)
        return model

    calls = graphs.port_replay()
    tb = {"points": _t(b["points"]), "colors": _t(b["colors"]), "labels": _t(b["labels"]).long()}
    cw = torch.from_numpy(CLASS_WEIGHTS)
    model = port_model().train()
    logits = model(tb["points"], tb["colors"])
    loss = losses.weighted_cross_entropy(logits, tb["labels"], cw)
    loss.backward()
    calls.clear()
    sgd_model = port_model()
    metrics = make_train_step(sgd_model, Config().loss, torch.optim.SGD(
        sgd_model.parameters(), lr=SGD_LR))(tb, SGD_LR, cw)
    assert len(calls) == 4
    to64 = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), t)  # noqa: E731
    grads = {k: p.grad for k, p in model.named_parameters()}
    return want32, want64, {
        "loss": float(loss.detach()),
        "sgd_loss": float(metrics["loss"]),
        "logits": logits.detach().double().numpy(),
        "grads": to64(state_dict_to_flax(grads, name)["params"]),
        "batch_stats": to64(state_dict_to_flax(model.state_dict(), name)["batch_stats"]),
        "sgd_params": to64(state_dict_to_flax(sgd_model.state_dict(), name)["params"]),
        "torch_grads": grads,
    }


@pytest.fixture(scope="module")
def steps():
    mp = pytest.MonkeyPatch()
    try:
        out = {}
        for name in MODULES:
            out[name] = _step(name, mp)
            mp.undo()
        return out
    finally:
        mp.undo()


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


@pytest.mark.parametrize("name", sorted(MODULES))
def test_train_loss_matches_jax(steps, name):
    """Within 1e-5 relative of the float64 step plus twice the JAX float32
    step's own error: DGCNNGlobal's bn6 and bn7 normalise over the B = 2
    rows of the batch, where the JAX float32 loss is 7e-4 from float64."""
    want32, want64, got = steps[name]
    tol = 1e-5 * abs(want64["loss"]) + 2 * abs(want32["loss"] - want64["loss"])
    for key in ("loss", "sgd_loss"):
        assert abs(got[key] - want64["loss"]) <= tol, (key, got[key], want64["loss"], tol)


@pytest.mark.parametrize("name", sorted(MODULES))
def test_train_mode_logits_match_jax(steps, name):
    assert steps[name][2]["logits"].shape == (2, 128, 5)
    _check("logits", None, lambda r: 2e-4, steps[name])


@pytest.mark.parametrize("name,module", CASES)
def test_gradients_match_jax(steps, name, module):
    _check("grads", module, lambda r: 2e-4 * np.abs(r).max() + 1e-6, steps[name])


@pytest.mark.parametrize("name,module", [(n, m) for n in STATS for m in STATS[n]])
def test_batch_stats_match_jax(steps, name, module):
    """The running variance takes the biased batch variance, as flax does;
    an EdgeConv's BatchNorm normalises over [B, N, k]."""
    _check("batch_stats", module, lambda r: 1e-5 * np.abs(r).max(), steps[name])


@pytest.mark.parametrize("name,module", CASES)
def test_sgd_step_matches_jax(steps, name, module):
    _check("sgd_params", module, lambda r: 1e-6, steps[name])


@pytest.mark.parametrize("name", sorted(MODULES))
def test_every_parameter_gets_a_gradient(steps, name):
    """Every parameter reaches the loss, through the graph features' gather
    among others: present, finite, non-zero, except the biases in front of
    a BatchNorm, whose gradient is exactly 0 and stays below 1e-4 * max|g|
    of the layer's weight in both packages."""
    want32, _, got = steps[name]
    grads = got["torch_grads"]
    for key, g in grads.items():
        assert g is not None and torch.isfinite(g).all(), key
        layer = key.rsplit(".", 1)[0]
        if key.endswith(".bias") and layer in PRE_BN[name]:
            bound = 1e-4 * grads[layer + ".weight"].abs().max().item()
            jbias = want32["grads"][PRE_BN[name][layer]]["bias"]
            jweight = want32["grads"][PRE_BN[name][layer]]
            jbound = 1e-4 * np.abs(jweight.get("kernel", jweight.get("scale"))).max()
            assert np.abs(jbias).max() <= jbound, key
            assert g.abs().max().item() <= bound, key
        else:
            assert g.abs().max() > 0, key


def test_batch_norms_normalise_over_the_neighbours_too():
    """An EdgeConv's BatchNorm takes its statistics over B * N * k rows."""
    bn = BatchNorm(4).train()
    x = torch.randn(2, 8, 5, 4)
    bn(x)
    var = x.reshape(-1, 4).var(0, unbiased=False)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var)


# ------------------------------------------------------ the recipe, end to end


def test_the_recipe_trains_through_train_cli_and_infer_cli_serves_it(tmp_path, monkeypatch,
                                                                     capsys):
    """configs/train_dgcnn.yaml as a user runs it (DGCNN, k = 20, Adam,
    plateau), with the data directories, a small block and one epoch as
    flags, on the CPU; then ``infer_cli blocks`` serves the checkpoint it
    wrote."""
    for sub, seed in (("train", 0), ("val", 1)):
        d = tmp_path / sub
        d.mkdir()
        xyz, rgb, labels = toy_bridge_scene(3000, seed=seed)
        write_las(str(d / f"scene{seed}.las"), xyz, rgb, labels)
    monkeypatch.chdir(tmp_path)  # exp_dir_root is relative
    recipe = os.path.join(REPO, "configs", "train_dgcnn.yaml")
    cfg = Config.from_yaml(recipe)
    assert (cfg.model.name, cfg.train.batch_size, cfg.data.num_points, cfg.train.scheduler,
            cfg.train.learning_rate) == ("dgcnn", 16, 4096, "plateau", 1e-3)
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
    infer_cli.main(["blocks", "--checkpoint", exp, "--model", "dgcnn",
                    "--data-dir", str(tmp_path / "val"), "--out-dir", str(tmp_path / "served"),
                    "--num-points", "128", "--batch-size", "4", "--device", "cpu"])
    assert "GLOBAL mIoU=" in capsys.readouterr().out
    cm = np.loadtxt(tmp_path / "served" / "confusion_matrix.csv", delimiter=",")
    assert cm.shape == (5, 5) and cm.sum() > 0 and cm.sum() % 128 == 0
