"""The port's data-parallel step against the JAX package's, on the CPU.

The JAX package runs its own mesh steps on the conftest's virtual devices
(``make_mesh(2)``, ``shard_map``); the port runs two gloo ranks
(tests/torch_ranks.py), spawned once for the module while the JAX side
compiles. Both start from the same seeded SSG (the port's weights carried
to flax by ``state_dict_to_flax``) and batch, dropout 0, the default
``weighted_ce`` loss with class weights. The batch's two halves have skewed
label mixes, so the mean of the ranks' weighted losses, which is the JAX dp
step's loss, differs from the global batch's weighted loss: the port must
keep the former.

The bands are those of tests/test_torch_train.py: each quantity held to the
JAX step computed in float64 within the base tolerance (gradients
2e-4 * max|g| + 1e-6, BatchNorm statistics 1e-5 * max|stat|, SGD
parameters 1e-6) plus twice the JAX package's own float32 error on that
leaf; the loss within 1e-5 relative of the JAX float32 step; Adam against
optax on the port's own gradients.
"""

import torch_cpu  # noqa: F401  (first: torch's threads a worker)

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pointcloud_bridge_tpu.config import Config
from pointcloud_bridge_tpu.models.pointnet2 import PointNet2SSG as JaxSSG
from pointcloud_bridge_tpu.parallel import (
    make_dp_eval_step,
    make_dp_multi_train_step,
    make_dp_train_step,
    make_mesh,
    replicate,
    shard_batch,
)
from pointcloud_bridge_tpu.train.loop import TrainState
from pointcloud_bridge_tpu_torch.utils.weights import flax_to_state_dict, state_dict_to_flax

from torch_ranks import (
    ADAM_LR,
    CLASS_WEIGHTS,
    EMA_DECAY,
    SA_NPOINTS,
    SGD_LR,
    Ranks,
    skewed_batch,
    ssg,
)

# optax's identity that also keeps the (pmean'd) gradients as its state:
# the step's parameters are then a plain-SGD step, its opt_state the
# gradient itself
RECORD = optax.GradientTransformation(
    lambda p: jax.tree_util.tree_map(jnp.zeros_like, p), lambda u, s, p=None: (u, u))


def to64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def flax_of(state):
    """A port state_dict (or gradient dict) as float64 flax trees."""
    return to64(state_dict_to_flax({k: v.detach() for k, v in state.items()}))


def jax_model(dtype, axis="data"):
    return JaxSSG(num_classes=5, sa_npoints=SA_NPOINTS, dropout_rate=0.0, axis_name=axis,
                  compute_dtype=np.dtype(dtype).name)


def in_dtype(fn, dtype, *args):
    """fn(*args) with x64 on for float64."""
    if dtype != np.float64:
        return fn(*args)
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        return fn(*args)
    finally:
        jax.config.update("jax_enable_x64", x64)


def cast(tree, dtype):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, dtype) if np.asarray(a).dtype == np.float32 else np.asarray(a),
        tree)


def jax_state(variables, dtype):
    v = cast(variables, dtype)
    return TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                      batch_stats=v["batch_stats"], opt_state=RECORD.init(v["params"]))


def jax_dp_step(variables, batch, dtype):
    """One JAX dp step over two devices: loss, accuracy, the pmean'd
    gradients, the BatchNorm statistics and the SGD step's parameters."""
    def run():
        mesh = make_mesh(2)
        step = make_dp_train_step(jax_model(dtype), Config().loss, RECORD, mesh, donate=False)
        state, m = step(replicate(jax_state(variables, dtype), mesh),
                        shard_batch(cast(batch, dtype), mesh), jnp.asarray(SGD_LR, dtype),
                        replicate(jnp.asarray(CLASS_WEIGHTS, dtype), mesh),
                        jax.random.PRNGKey(0))
        return to64({"loss": m["loss"], "acc": m["acc"], "grads": state.opt_state,
                     "batch_stats": state.batch_stats, "sgd_params": state.params})
    return in_dtype(run, dtype)


def jax_dp_multi(variables, batches, dtype):
    """K = 2 JAX dp steps in one dispatch with the EMA."""
    def run():
        mesh = make_mesh(2)
        step = make_dp_multi_train_step(jax_model(dtype), Config().loss, RECORD, mesh, 2,
                                        donate=False, ema_decay=EMA_DECAY)
        state = replicate(jax_state(variables, dtype), mesh)
        state, ema, m = step(state, replicate(state.params, mesh),
                             shard_batch(cast(batches, dtype), mesh, dim=1),
                             jnp.asarray(SGD_LR, dtype),
                             replicate(jnp.asarray(CLASS_WEIGHTS, dtype), mesh),
                             jax.random.PRNGKey(0))
        return to64({"loss": m["loss"], "batch_stats": state.batch_stats,
                     "sgd_params": state.params, "ema": ema})
    return in_dtype(run, dtype)


def check_tree(got, want32, want64, base, what):
    """Per leaf: |port - ref64| <= base(ref64) + 2 |jax32 - ref64|."""
    ref = jax.tree_util.tree_leaves_with_path(want64)
    j32 = dict(jax.tree_util.tree_leaves_with_path(want32))
    port = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(ref) == len(j32) == len(port) > 0, what
    for path, r in ref:
        assert port[path].shape == r.shape, (what, path)
        err = np.abs(port[path] - r).max()
        tol = base(r) + 2 * np.abs(j32[path] - r).max()
        assert err <= tol, (f"{what}{jax.tree_util.keystr(path)}: "
                            f"|port - f64| {err:.3g} > {tol:.3g}")


GRAD_BAND = lambda r: 2e-4 * np.abs(r).max() + 1e-6  # noqa: E731
STAT_BAND = lambda r: 1e-5 * np.abs(r).max()  # noqa: E731
SGD_BAND = lambda r: 1e-6  # noqa: E731


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """(JAX float32, JAX float64, the two ranks' results, the variables)."""
    ranks = Ranks("dp", 2, tmp_path_factory.mktemp("dp")).start()
    variables = state_dict_to_flax(ssg(0).state_dict())
    b = skewed_batch()
    want32 = jax_dp_step(variables, b, np.float32)
    want64 = jax_dp_step(variables, b, np.float64)
    return want32, want64, ranks.join(), variables


def test_ranks_agree_and_replicate_rank_0(dp):
    """replicate() gave rank 1 (its weights moved) rank 0's state exactly,
    and the step left both ranks with the same bits."""
    r0, r1 = dp[2]
    want = ssg(0).state_dict()
    for k, v in want.items():
        assert torch.equal(r0["replicated"][k], v) and torch.equal(r1["replicated"][k], v), k
    for key in ("grads", "state"):
        for k in r0[key]:
            assert torch.equal(r0[key][k], r1[key][k]), (key, k)
    assert r0["loss"] == r1["loss"] and r0["acc"] == r1["acc"]


def test_dp_loss_is_the_mean_of_the_ranks_losses(dp):
    """The loss agrees with the JAX dp step's, the mean over the ranks of
    their weighted losses, which the skewed label mixes set apart from the
    weighted loss of the global batch (the single-device step's). It is
    held to the JAX float64 step within 1e-5 relative plus twice the JAX
    float32 step's own error: that float32 loss is 2.1e-5 from its float64
    one, too far for 1e-5 of it alone."""
    want32, want64, (r0, _), _ = dp
    check_tree({"loss": np.float64(r0["loss"])}, {"loss": want32["loss"]},
               {"loss": want64["loss"]}, lambda r: 1e-5 * np.abs(r).max(), "loss")
    from pointcloud_bridge_tpu_torch import losses

    b = skewed_batch()
    model = ssg(0).train()
    logits = model(torch.from_numpy(b["points"]), torch.from_numpy(b["colors"]))
    whole = float(losses.weighted_cross_entropy(
        logits, torch.from_numpy(b["labels"]).long(), torch.from_numpy(CLASS_WEIGHTS)))
    assert abs(r0["loss"] - whole) > 100 * 1e-5 * abs(r0["loss"])


def test_dp_accuracy_matches_jax(dp):
    want32, _, (r0, _), _ = dp
    assert abs(r0["acc"] - want32["acc"]) <= 1.0 / (2 * 128)


@pytest.mark.parametrize("key,base", [("grads", GRAD_BAND), ("batch_stats", STAT_BAND),
                                      ("sgd_params", SGD_BAND)])
def test_dp_step_matches_jax(dp, key, base):
    want32, want64, (r0, _), _ = dp
    if key == "grads":
        got = flax_of(r0["grads"])["params"]
    else:
        got = flax_of(r0["state"])["batch_stats" if key == "batch_stats" else "params"]
    check_tree(got, want32[key], want64[key], base, key)


def test_dp_adam_matches_optax_on_the_ranks_gradients(dp):
    """make_optimizer's Adam on the all-reduced gradients against optax's
    chain(add_decayed_weights, scale_by_adam) on the same gradients."""
    adam = dp[2][0]["adam"]
    names = list(adam["grads"])
    opt = optax.chain(optax.add_decayed_weights(1e-4), optax.scale_by_adam(b1=0.9, b2=0.999))
    params = [jnp.asarray(adam["before"][k].numpy()) for k in names]
    upd, _ = opt.update([jnp.asarray(adam["grads"][k].numpy()) for k in names],
                        opt.init(params), params)
    for k, p, u in zip(names, params, upd):
        np.testing.assert_allclose(adam["after"][k].numpy(), np.asarray(p - ADAM_LR * u),
                                   rtol=0, atol=1e-6, err_msg=k)


def test_dp_eval_step_matches_jax(dp):
    """The confusion matrix is the JAX dp eval's exactly (the masked row
    apart on both sides), the loss within 1e-5."""
    variables = dp[3]
    b = skewed_batch(4, 128, seed=5)
    b["mask"][3] = False
    mesh = make_mesh(2)
    cm, loss = make_dp_eval_step(jax_model(np.float32), 5, mesh)(
        replicate(variables["params"], mesh), replicate(variables["batch_stats"], mesh),
        shard_batch(b, mesh),
        replicate(jnp.asarray(CLASS_WEIGHTS), mesh))
    got_cm, got_loss = dp[2][0]["eval"]
    np.testing.assert_array_equal(got_cm.numpy(), np.asarray(cm))
    assert got_cm.sum() == 3 * 128
    np.testing.assert_allclose(got_loss, float(loss), rtol=1e-5)


@pytest.mark.parametrize("n_blocks", [1, 2, 3])
def test_dp_eval_step_shards_a_padded_batch(dp, n_blocks):
    """A dataset of 1-3 blocks at batch 4: the padded batch holds 4 rows of
    points, colours, labels and mask, and the dp eval step over the two
    ranks counts exactly the real rows."""
    b, cm, loss = dp[2][0]["padded"][n_blocks]
    assert b["points"].shape == (4, 64, 3) and b["colors"].shape == (4, 64, 3)
    assert b["labels"].shape == (4, 64) and b["mask"].shape == (4,)
    assert b["mask"].sum() == n_blocks and b["mask"][:n_blocks].all()
    assert list(b["block_ids"]) == [i % n_blocks for i in range(4)]
    assert cm.sum() == n_blocks * 64 and np.isfinite(loss)


@pytest.mark.parametrize("n_blocks", [1, 2, 3])
def test_padded_batch_rows_agree(n_blocks):
    """BlockDataset.batches pads a short last batch by wrapping its order
    around: every key has batch rows, also below half a batch of blocks."""
    from torch_ranks import padded_batches

    from pointcloud_bridge_tpu_torch.train import make_eval_step
    from pointcloud_bridge_tpu_torch.train.loop import batch_to_device

    (b,) = padded_batches(n_blocks)
    assert {k: v.shape[0] for k, v in b.items()} == dict.fromkeys(b, 4)
    cm, loss = make_eval_step(ssg(0), 5)(batch_to_device(b, "cpu"),
                                         torch.from_numpy(CLASS_WEIGHTS))
    assert cm.sum() == n_blocks * 64 and torch.isfinite(loss)


def test_a_mesh_needs_a_process_group():
    """make_mesh raises without an initialised default group, as a sync-BN
    forward does on an axis no mesh bound."""
    from pointcloud_bridge_tpu_torch import parallel
    from pointcloud_bridge_tpu_torch.utils.collectives import axis_group

    with pytest.raises(RuntimeError, match="no process group"):
        parallel.make_mesh(2)
    with pytest.raises(RuntimeError, match="bound to no process group"):
        axis_group("nowhere")
    with pytest.raises(RuntimeError, match="bound to no process group"):
        ssg(0, "nowhere").train()(torch.rand(2, 64, 3), torch.rand(2, 64, 3))


def test_dp_replicated_weights_round_trip(dp):
    """The replicated state dict through the flax-name rules and back, bit
    for bit."""
    sd = dp[2][1]["replicated"]
    back = flax_to_state_dict(state_dict_to_flax(sd))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(torch.as_tensor(np.asarray(back[k])), v), k


def test_cpu_batchnorm_does_not_depend_on_the_thread_count():
    """The port's CPU BatchNorm (single-device path, train mode) gives the
    same bits at 1 and 4 torch threads, and its gradients stay within 2e-6
    of max|g| of the float64 ones: over [rows, C] torch's CPU kernel sums
    each channel's rows in sequence within a thread, which a channel-major
    copy avoids."""
    from pointcloud_bridge_tpu_torch.models import BatchNorm

    g = torch.Generator().manual_seed(0)
    x = torch.randn(40960, 64, generator=g, dtype=torch.float64) * 3 + 1
    go = torch.randn(40960, 64, generator=g, dtype=torch.float64) + 0.3

    def run(dtype, threads):
        before = torch.get_num_threads()
        torch.set_num_threads(threads)
        try:
            bn = BatchNorm(64).to(dtype).train()
            xx = x.to(dtype).requires_grad_(True)
            bn(xx).backward(go.to(dtype))
            return [t.detach().double() for t in (xx.grad, bn.weight.grad, bn.bias.grad)]
        finally:
            torch.set_num_threads(before)

    one, four, exact = run(torch.float32, 1), run(torch.float32, 4), run(torch.float64, 4)
    for a, b, r in zip(one, four, exact):
        assert torch.equal(a, b)
        assert (a - r).abs().max() <= 2e-6 * r.abs().max()
