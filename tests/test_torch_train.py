"""The PyTorch port's SSG train step and training engine against the JAX
package, on the CPU.

The JAX train-mode step (dropout 0, weighted CE with class weights,
``mutable=["batch_stats"]``) and the port's run on the same seeded inputs and
weights (``flax_to_state_dict``, BatchNorm moved away from the identity).

What float32 can show here: 17 train-mode BatchNorms in sequence amplify
rounding about a thousandfold, so the JAX package's own float32 step is
1-8% of max|g| away from the same step computed in float64, and it moves by
1-3% when its input colours change by one part in 10^7. No float32
implementation can be held to 2e-4 * max|g| of another. So each quantity is
held to the JAX step in float64 (``compute_dtype="float64"`` under x64, the
same weights and indices): the port must be within the base tolerance
(logits 2e-4, gradients 2e-4 * max|g| + 1e-6, BatchNorm statistics
1e-5 * max|stat|, SGD parameters 1e-6) plus twice the JAX package's own
float32 error on that leaf. The loss agrees with the JAX float32 step within
1e-5 relative. A plain-SGD step goes through both ``make_train_step``s; Adam
is held against optax on identical gradients (it flips signs on near-zero
gradients, so two gradient computations would not compare).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pointcloud_bridge_tpu import losses as JL
from pointcloud_bridge_tpu.config import Config
from pointcloud_bridge_tpu.data import BlockDataset, make_training_blocks
from pointcloud_bridge_tpu.data.synthetic import toy_bridge_scene
from pointcloud_bridge_tpu.models.pointnet2 import PointNet2SSG as JaxSSG
from pointcloud_bridge_tpu.train.loop import TrainState
from pointcloud_bridge_tpu.train.loop import make_train_step as jax_make_train_step
from pointcloud_bridge_tpu_torch import losses
from pointcloud_bridge_tpu_torch.models import get_model
from pointcloud_bridge_tpu_torch.train import make_optimizer, make_train_step, set_lr, train
from pointcloud_bridge_tpu_torch.utils.checkpoint import restore_checkpoint
from pointcloud_bridge_tpu_torch.utils.weights import flax_to_state_dict, state_dict_to_flax

from test_torch_ssg import randomize_bn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SA_NPOINTS = (128, 32, 8)
CLASS_WEIGHTS = np.array([0.7, 1.3, 2.0, 0.5, 1.1], np.float32)
SGD_LR = 0.1
MODULES = ["sa1", "sa2", "sa3", "fp3", "fp2", "fp1", "head"]


def _port_model(variables):
    model = get_model("pointnet2_ssg", 5, sa_npoints=SA_NPOINTS, dropout_rate=0.0)
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    return model


def _batch():
    rng = np.random.default_rng(0)
    return {
        "points": rng.uniform(size=(2, 512, 3)).astype(np.float32),
        "colors": rng.uniform(size=(2, 512, 3)).astype(np.float32),
        "labels": rng.integers(0, 5, size=(2, 512)).astype(np.int32),
    }


def _jax_step(variables, b, dtype):
    """Loss, logits, gradients, updated batch_stats and one plain-SGD
    step's parameters of the JAX package, computing in ``dtype``."""
    jmodel = JaxSSG(num_classes=5, sa_npoints=SA_NPOINTS, dropout_rate=0.0,
                    compute_dtype=np.dtype(dtype).name)
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
    state = TrainState(
        step=jnp.zeros((), jnp.int32), params=v["params"], batch_stats=v["batch_stats"],
        opt_state=optax.identity().init(None),
    )
    sgd, _ = jax_make_train_step(jmodel, Config().loss, optax.identity(), donate=False)(
        state, {k: jnp.asarray(x) for k, x in b.items()}, jnp.asarray(SGD_LR, dtype), cw,
        jax.random.PRNGKey(0),
    )
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), {
        "loss": loss, "logits": logits, "grads": grads, "batch_stats": stats,
        "sgd_params": sgd.params,
    })


@pytest.fixture(scope="module")
def step():
    """(JAX float32, JAX float64, port) results of one train step."""
    b = _batch()
    jmodel = JaxSSG(num_classes=5, sa_npoints=SA_NPOINTS)
    variables = randomize_bn(jax.jit(
        lambda x, c: jmodel.init(jax.random.PRNGKey(0), x, c, train=False)
    )(b["points"], b["colors"]))
    want32 = _jax_step(variables, b, np.float32)
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        want64 = _jax_step(variables, b, np.float64)
    finally:
        jax.config.update("jax_enable_x64", x64)

    tb = {"points": torch.from_numpy(b["points"]), "colors": torch.from_numpy(b["colors"]),
          "labels": torch.from_numpy(b["labels"]).long()}
    cw = torch.from_numpy(CLASS_WEIGHTS)
    model = _port_model(variables)
    model.train()
    logits = model(tb["points"], tb["colors"])
    loss = losses.weighted_cross_entropy(logits, tb["labels"], cw)
    loss.backward()
    sgd_model = _port_model(variables)
    metrics = make_train_step(sgd_model, Config().loss, torch.optim.SGD(
        sgd_model.parameters(), lr=SGD_LR))(tb, SGD_LR, cw)
    to64 = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), t)  # noqa: E731
    got = {
        "loss": float(loss.detach()),
        "sgd_loss": float(metrics["loss"]),
        "logits": logits.detach().double().numpy(),
        "grads": to64(state_dict_to_flax({k: p.grad for k, p in model.named_parameters()})["params"]),
        "batch_stats": to64(state_dict_to_flax(model.state_dict())["batch_stats"]),
        "sgd_params": to64(state_dict_to_flax(sgd_model.state_dict())["params"]),
        "model": model,
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
    np.testing.assert_allclose(got["loss"], want32["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["sgd_loss"], want32["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["loss"], want64["loss"], rtol=1e-5)


def test_train_mode_logits_match_jax(step):
    assert step[2]["logits"].shape == (2, 512, 5)
    _check("logits", None, lambda r: 2e-4, step)


@pytest.mark.parametrize("module", MODULES)
def test_gradients_match_jax(step, module):
    _check("grads", module, lambda r: 2e-4 * np.abs(r).max() + 1e-6, step)


@pytest.mark.parametrize("module", MODULES)
def test_batch_stats_match_jax(step, module):
    """The running variance takes the biased batch variance, as flax does."""
    _check("batch_stats", module, lambda r: 1e-5 * np.abs(r).max(), step)


@pytest.mark.parametrize("module", MODULES)
def test_sgd_step_matches_jax(step, module):
    _check("sgd_params", module, lambda r: 1e-6, step)


def test_every_sa_and_fp_parameter_gets_a_gradient(step):
    """Every parameter of sa1-sa3 and fp1-fp3 reaches the loss through the
    group and interpolation Functions."""
    model = step[2]["model"]
    for name, p in model.named_parameters():
        if name.startswith(("sa", "fp")):
            assert p.grad is not None, name
            assert p.grad.abs().max() > 0, name


def allow_capturable_on_cpu(monkeypatch):
    """torch's capturable Adam asserts a CUDA-like device; widen the check
    so that its arithmetic runs here (the test's own doing)."""
    import torch.optim.adam as adam_mod

    supported = adam_mod._get_capturable_supported_devices
    monkeypatch.setattr(adam_mod, "_get_capturable_supported_devices",
                        lambda *a, **k: list(supported(*a, **k)) + ["cpu"])


@pytest.mark.parametrize("capturable", [False, True], ids=["eager", "capturable"])
def test_adam_matches_optax_on_identical_gradients(monkeypatch, rng, capturable):
    """make_optimizer, the eager Adam and the capturable one that the
    multi-step path replays on the card (its bias corrections in float32
    tensors, the foreach arithmetic the card runs), against optax: every
    parameter within 1e-6 after each of three steps."""
    if capturable:
        allow_capturable_on_cpu(monkeypatch)
    shapes = [(64, 6), (64,), (5, 128)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes] for _ in range(3)]
    lr = 1e-3
    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = make_optimizer(tparams, weight_decay=1e-4, capturable=capturable)
    jopt = optax.chain(optax.add_decayed_weights(1e-4), optax.scale_by_adam(b1=0.9, b2=0.999))
    jparams = [jnp.asarray(p) for p in params]
    jstate = jopt.init(jparams)
    for g in grads:
        for p, gg in zip(tparams, g):
            p.grad = torch.from_numpy(gg)
        set_lr(opt, lr)
        opt.step()
        upd, jstate = jopt.update([jnp.asarray(x) for x in g], jstate, jparams)
        jparams = optax.apply_updates(jparams, jax.tree_util.tree_map(lambda u: -lr * u, upd))
        for p, jp in zip(tparams, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=0, atol=1e-6)


# ------------------------------------------------------------ the engine


def _tiny_dataset(seed):
    xyz, rgb, labels = toy_bridge_scene(6000, seed=seed)
    blocks = make_training_blocks(
        xyz, rgb, labels, num_points=128, block_size=4.0, sample_rate=0.3,
        file_name=f"scene{seed}", seed=seed,
    )[:4]
    return BlockDataset.from_blocks(blocks, [f"scene{seed}"])


def _tiny_config(epochs):
    cfg = Config()
    cfg.device = "cpu"
    cfg.model.extra = {"sa_npoints": (32, 16, 8)}
    cfg.train.batch_size = 2
    cfg.train.num_epochs = epochs
    cfg.train.scheduler = "cosine"
    cfg.train.prefetch = 2
    return cfg


def test_train_writes_checkpoints_and_resumes(tmp_path):
    tr, va = _tiny_dataset(0), _tiny_dataset(1)
    exp = str(tmp_path / "exp")
    out = train(_tiny_config(2), tr, va, exp_dir=exp)
    assert [r["epoch"] for r in out["history"]] == [1, 2]
    for r in out["history"]:
        assert np.isfinite(r["train_loss"]) and np.isfinite(r["val_loss"])
        assert 0.0 <= r["val_acc"] <= 1.0
    for name in ("best_model", "latest_checkpoint", "scalars.csv", "training.log"):
        assert os.path.exists(os.path.join(exp, name)), name
    assert os.path.isdir(os.path.join(exp, "code_snapshot", "pointcloud_bridge_tpu_torch"))
    latest = restore_checkpoint(os.path.join(exp, "latest_checkpoint"))
    assert latest["epoch"] == 2 and set(latest) == {"model", "optimizer", "epoch"}
    for k, v in out["model"].state_dict().items():
        assert torch.equal(latest["model"][k], v), k

    # the epoch counter continues from the stored epoch
    out2 = train(_tiny_config(3), tr, va, exp_dir=exp, resume=True)
    assert [r["epoch"] for r in out2["history"]] == [3]
    assert restore_checkpoint(os.path.join(exp, "latest_checkpoint"))["epoch"] == 3


def test_train_warm_starts_from_weights_only_checkpoint(tmp_path):
    tr = _tiny_dataset(0)
    exp = tmp_path / "exp"
    exp.mkdir()
    src = get_model("pointnet2_ssg", 5, sa_npoints=(32, 16, 8),
                    generator=torch.Generator().manual_seed(7))
    torch.save({"model": src.state_dict()}, exp / "best_model")
    cfg = _tiny_config(1)
    cfg.train.learning_rate = 0.0
    out = train(cfg, tr, None, exp_dir=str(exp), resume=True)
    assert [r["epoch"] for r in out["history"]] == [1]
    # lr 0: the weights are the warm start's, unchanged by the step
    got = out["model"].state_dict()
    assert torch.equal(got["conv2.weight"], src.state_dict()["conv2.weight"])


@pytest.mark.parametrize("knob", ["accum_steps", "steps_per_dispatch"])
def test_unported_engine_options_raise(tmp_path, knob):
    """steps_per_dispatch > 1 trains (on the CPU: K eager steps a dispatch);
    with accum_steps > 1 as well it raises as the JAX trainer does
    (loop.py:404-406)."""
    cfg = _tiny_config(1)
    cfg.train.steps_per_dispatch = 2
    if knob == "accum_steps":
        cfg.train.accum_steps = 2
        with pytest.raises(ValueError, match="mutually exclusive"):
            train(cfg, _tiny_dataset(0), None, exp_dir=str(tmp_path))
        return
    out = train(cfg, _tiny_dataset(0), None, exp_dir=str(tmp_path))
    assert [r["epoch"] for r in out["history"]] == [1]
    assert np.isfinite(out["history"][0]["train_loss"])
    # 4 blocks at batch 2: one stacked dispatch of two Adam steps
    state = out["state"]["optimizer"]["state"]
    assert {float(st["step"]) for st in state.values()} == {2.0}


def test_train_cli_on_cpu(tmp_path, monkeypatch):
    from pointcloud_bridge_tpu.data import write_las
    from pointcloud_bridge_tpu_torch import train_cli

    for sub, seed in (("train", 0), ("val", 1)):
        d = tmp_path / sub
        d.mkdir()
        xyz, rgb, labels = toy_bridge_scene(6000, seed=seed)
        write_las(str(d / f"scene{seed}.las"), xyz, rgb, labels)
    monkeypatch.chdir(tmp_path)  # exp_dir_root is relative
    out = train_cli.main([
        "--train-dir", str(tmp_path / "train"), "--val-dir", str(tmp_path / "val"),
        "--num-points", "128", "--batch-size", "4", "--num-epochs", "1",
        "--sampler", "random", "--device", "cpu", "--case", "cli",
    ])
    assert out["exp_dir"].endswith("_cli") and len(out["history"]) == 1
    assert np.isfinite(out["history"][0]["train_loss"])


def test_train_cli_refuses_a_missing_card(tmp_path):
    from pointcloud_bridge_tpu_torch import train_cli

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--train-dir", str(tmp_path)])


def test_training_modules_import_no_jax():
    code = (
        "import sys\n"
        "import pointcloud_bridge_tpu_torch.train, pointcloud_bridge_tpu_torch.losses\n"
        "import pointcloud_bridge_tpu_torch.train_cli, pointcloud_bridge_tpu_torch.config\n"
        "from pointcloud_bridge_tpu_torch.utils import checkpoint, metrics, weights\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'flax', 'optax', 'orbax')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
