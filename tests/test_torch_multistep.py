"""Multi-step dispatch of the port (train/loop.py: group_batches,
MultiTrainStep, MultiEvalStep, train() at train.steps_per_dispatch > 1), its
capture-safe counts, and utils/determinism.py and utils/profiling.py, on
the CPU.

On the CPU a dispatch is K eager steps in a loop (the card replays a CUDA
graph of the same steps; chip_smoke.py phases 38-39 hold that graph to
the eager steps with torch.equal). So here K steps in one dispatch are held
to K single steps bit for bit, and train() at steps_per_dispatch 2 to
steps_per_dispatch 1 bit for bit. Against the JAX package: group_batches
exactly; the multi-step eval on converted weights, the loss within 1e-5
relative (float32 sums in another order) and the confusion matrix exactly
but for points whose two largest logits lie within 1e-4 (a flip there is a
rounding); train() against the JAX train() at steps_per_dispatch 2 from
the same weights (slow), within the JAX package's own band for its two
engines (see test_train_matches_jax_train_at_two_steps_a_dispatch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_bridge_tpu.config import Config as JaxConfig
from pointcloud_bridge_tpu.data import BlockDataset as JaxBlockDataset
from pointcloud_bridge_tpu.data import make_training_blocks
from pointcloud_bridge_tpu.data.synthetic import toy_bridge_scene
from pointcloud_bridge_tpu.models import get_model as jax_get_model
from pointcloud_bridge_tpu.train import train as jax_train
from pointcloud_bridge_tpu.train.loop import group_batches as jax_group_batches
from pointcloud_bridge_tpu.train.loop import make_eval_step as jax_make_eval_step
from pointcloud_bridge_tpu.train.loop import make_multi_eval_step as jax_make_multi_eval_step
from pointcloud_bridge_tpu_torch import losses
from pointcloud_bridge_tpu_torch.config import Config, LossConfig
from pointcloud_bridge_tpu_torch.data import BlockDataset
from pointcloud_bridge_tpu_torch.models import Dropout, get_model
from pointcloud_bridge_tpu_torch.models.randlanet import _upsample_plan
from pointcloud_bridge_tpu_torch.train import (
    MultiEvalStep,
    MultiTrainStep,
    group_batches,
    make_eval_step,
    make_optimizer,
    make_train_step,
    set_lr,
    train,
)
from pointcloud_bridge_tpu_torch.train.loop import StepState, ema_update, model_generators
from pointcloud_bridge_tpu_torch.utils import metrics as M
from pointcloud_bridge_tpu_torch.utils.determinism import set_random_seed
from pointcloud_bridge_tpu_torch.utils.profiling import (
    device_time,
    live_memory,
    points_per_second,
    span,
)
from pointcloud_bridge_tpu_torch.utils.weights import flax_to_state_dict, state_dict_to_flax

from test_torch_train import allow_capturable_on_cpu


def _batch(b, n=64, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "points": rng.uniform(size=(b, n, 3)).astype(np.float32),
        "colors": rng.uniform(size=(b, n, 3)).astype(np.float32),
        "labels": rng.integers(0, 5, (b, n)).astype(np.int32),
        "mask": np.ones(b, bool),
        "block_ids": np.arange(b, dtype=np.int32),
    }


# ------------------------------------------------------------ grouping


@pytest.mark.parametrize("k", [2, 3])
def test_group_batches_matches_jax(k):
    """The same numpy stream (full batches, a ragged final batch, then full
    ones again: a shape change in the middle) grouped identically."""
    stream = ([_batch(4, seed=s) for s in range(5)] + [_batch(2, seed=5)]
              + [_batch(4, seed=6 + s) for s in range(4)])
    got = list(group_batches(iter(stream), k))
    want = list(jax_group_batches(iter(stream), k))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in w:
            assert g[key].shape == w[key].shape and g[key].dtype == w[key].dtype
            np.testing.assert_array_equal(g[key], w[key])
    assert [g["points"].ndim for g in got].count(4) == 5 // k + 4 // k


# ------------------------------------------------------------ K steps


def _tensors(b):
    return {"points": torch.from_numpy(b["points"]), "colors": torch.from_numpy(b["colors"]),
            "labels": torch.from_numpy(b["labels"]).long(), "mask": torch.from_numpy(b["mask"])}


def _stacked(batches):
    return {key: torch.stack([b[key] for b in batches]) for key in batches[0]}


def _pointnet(seed=1):
    """pointnet (dropout 0.3 in its head) with its Dropout on one seeded
    generator, as the trainer gives it."""
    model = get_model("pointnet", 5, generator=torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = gen
    return model


def _outcome(model, optimizer, ema, gen):
    names = {id(p): k for k, p in model.named_parameters()}
    out = {f"sd {k}": v.clone() for k, v in model.state_dict().items()}
    out |= {f"adam {k} {names[id(p)]}": v.clone() for p, st in optimizer.state.items()
            for k, v in st.items()}
    out |= {f"ema {k}": v.clone() for k, v in ema.items()}
    out["generator"] = gen.get_state()
    return out


def test_multi_train_step_is_k_single_steps_bit_for_bit():
    """K = 3 steps in one dispatch against 3 make_train_step steps and
    their EMA updates, from one state (one step in: the moments exist):
    metrics, parameters, BatchNorm buffers, the Adam state, the EMA and the
    dropout generator's state, all with torch.equal. The model draws a
    dropout mask every step, so the three steps draw three masks."""
    model = _pointnet()
    (gen,) = model_generators(model)
    optimizer = make_optimizer(model.parameters())
    ema = {k: p.detach().clone() for k, p in model.named_parameters()}
    params = dict(model.named_parameters())
    multi = MultiTrainStep(model, LossConfig(), optimizer, 3, ema, 0.9)
    step = make_train_step(model, LossConfig(), optimizer)
    batches = [_tensors(_batch(2, seed=s)) for s in range(4)]
    cw = torch.tensor([0.7, 1.3, 2.0, 0.5, 1.1])
    step(batches[3], 1e-2, cw)
    ema_update(ema, params, 0.9)
    state = StepState(model, optimizer, ema, [gen])

    got = multi(_stacked(batches[:3]), 1e-2, cw)
    after = _outcome(model, optimizer, ema, gen)
    state.restore()
    single = []
    for b in batches[:3]:
        single.append(step(b, 1e-2, cw))
        ema_update(ema, params, 0.9)
    for key in ("loss", "acc"):
        assert got[key].shape == (3,)
        assert torch.equal(got[key], torch.stack([m[key] for m in single])), key
    want = _outcome(model, optimizer, ema, gen)
    assert after.keys() == want.keys()
    for key, value in want.items():
        assert torch.equal(after[key], value), key


def test_step_state_restores_the_same_tensors_in_place():
    """StepState.restore writes the values back into the very tensors (a
    captured graph reads those), zeroes optimizer state made after the
    snapshot, and rewinds the generators."""
    model = _pointnet(3)
    (gen,) = model_generators(model)
    optimizer = make_optimizer(model.parameters())
    ema = {k: p.detach().clone() for k, p in model.named_parameters()}
    before = {k: v.clone() for k, v in model.state_dict().items()}
    objects = [id(t) for t in (*model.parameters(), *model.buffers(), *ema.values())]
    state = StepState(model, optimizer, ema, [gen])
    g0 = gen.get_state()
    step = make_train_step(model, LossConfig(), optimizer)
    step(_tensors(_batch(2, seed=9)), 1e-2, torch.ones(5))
    ema_update(ema, dict(model.named_parameters()), 0.5)
    state.restore()
    assert [id(t) for t in (*model.parameters(), *model.buffers(), *ema.values())] == objects
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for k, p in model.named_parameters():
        assert torch.equal(ema[k], before[k]), k
    assert all(torch.equal(v, torch.zeros_like(v)) for st in optimizer.state.values()
               for v in st.values())
    assert torch.equal(gen.get_state(), g0)


def test_multi_steps_refuse_another_k():
    model = _pointnet()
    multi = MultiTrainStep(model, LossConfig(), make_optimizer(model.parameters()), 3)
    with pytest.raises(ValueError, match="stacked batch of 2"):
        multi(_stacked([_tensors(_batch(2, seed=s)) for s in range(2)]), 1e-2, torch.ones(5))
    with pytest.raises(ValueError, match="stacked batch of 2"):
        MultiEvalStep(make_eval_step(model, 5), 3)(
            _stacked([_tensors(_batch(2, seed=s)) for s in range(2)]), torch.ones(5))


def test_set_lr_fills_a_capturable_optimizers_tensor_in_place(monkeypatch):
    allow_capturable_on_cpu(monkeypatch)
    p = torch.nn.Parameter(torch.ones(3))
    opt = make_optimizer([p], capturable=True)
    lr = opt.param_groups[0]["lr"]
    assert torch.is_tensor(lr) and lr.shape == () and lr.dtype == torch.float32
    set_lr(opt, 0.25)
    assert opt.param_groups[0]["lr"] is lr and lr.item() == 0.25
    opt.param_groups[0]["lr"] = 0.5  # as a load_state_dict of an eager run leaves it
    set_lr(opt, 0.125)
    assert torch.is_tensor(opt.param_groups[0]["lr"])
    assert opt.param_groups[0]["lr"].item() == 0.125
    eager = make_optimizer([p])
    set_lr(eager, 0.25)
    assert eager.param_groups[0]["lr"] == 0.25


# ------------------------------------------------------------ the engine


def _blocks(seed, count, n=64):
    xyz, rgb, labels = toy_bridge_scene(6000, seed=seed)
    blocks = make_training_blocks(xyz, rgb, labels, num_points=n, block_size=4.0,
                                  sample_rate=0.3, file_name=f"scene{seed}", seed=seed)
    assert len(blocks) >= count
    return blocks[:count], [f"scene{seed}"]


def _config(cls, spd, model="pointnet", epochs=2):
    cfg = cls.from_dict({"case": f"spd{spd}", "num_classes": 5, "batch_size": 2,
                         "num_epochs": epochs, "learning_rate": 1e-3, "model": model})
    cfg.model.extra = {"dropout_rate": 0.0}
    if model == "pointnet2_ssg":
        cfg.model.extra["sa_npoints"] = (32, 16, 8)
    cfg.train.scheduler = "cosine"
    cfg.train.ema_decay = 0.9
    cfg.train.steps_per_dispatch = spd
    cfg.device = "cpu"
    return cfg


def test_train_at_two_steps_a_dispatch_is_one_step_a_dispatch_bit_for_bit(tmp_path):
    """train() over 3 training batches an epoch (a dispatch of 2 and a
    single step) and 3 validation batches (a dispatch of 2 and the padded
    single one), dropout on, EMA on: history and weights bit for bit."""
    tr = BlockDataset.from_blocks(*_blocks(0, 6))
    va = BlockDataset.from_blocks(*_blocks(1, 5))
    runs = {}
    for spd in (1, 2):
        cfg = _config(Config, spd)
        cfg.model.extra = {}  # pointnet's dropout 0.3
        runs[spd] = train(cfg, tr, va, exp_dir=str(tmp_path / f"spd{spd}"),
                          model=_pointnet(5))
    h1, h2 = runs[1]["history"], runs[2]["history"]
    assert len(h1) == len(h2) == 2
    for r1, r2 in zip(h1, h2):
        assert {k: v for k, v in r1.items() if k != "epoch_time_s"} == \
            {k: v for k, v in r2.items() if k != "epoch_time_s"}
    sd1, sd2 = runs[1]["model"].state_dict(), runs[2]["model"].state_dict()
    for k, v in sd1.items():
        assert torch.equal(v, sd2[k]), k
    assert runs[2]["graph_launches"] == {name: 0 for name in runs[2]["graph_launches"]}
    assert runs[1]["graph_launches"] is None


def _jax_eval_variables(seed=2):
    model = get_model("pointnet", 5, generator=torch.Generator().manual_seed(seed))
    variables = state_dict_to_flax(model.state_dict(), "pointnet")
    rng = np.random.default_rng(seed)
    stats = variables["batch_stats"]

    def walk(s):
        for key in s:
            if "mean" in s[key]:
                c = s[key]["mean"].shape
                s[key]["mean"] = (0.1 * rng.normal(size=c)).astype(np.float32)
                s[key]["var"] = (0.5 + rng.uniform(size=c)).astype(np.float32)
            else:
                walk(s[key])

    walk(stats)
    return variables


def test_multi_eval_matches_jax_multi_eval():
    """MultiEvalStep (K = 2, a padded batch among them) against JAX's
    make_multi_eval_step on the same converted weights: the summed
    confusion matrix and the stacked losses."""
    variables = _jax_eval_variables()
    model = get_model("pointnet", 5)
    model.load_state_dict(flax_to_state_dict(variables, "pointnet"), strict=True)
    batches = [_batch(2, n=64, seed=20), _batch(2, n=64, seed=21)]
    batches[1]["mask"][1] = False
    cw = np.array([0.7, 1.3, 2.0, 0.5, 1.1], np.float32)
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    jstep = jax_make_multi_eval_step(jax_make_eval_step(jax_get_model("pointnet", 5), 5), 2)
    jcm, jloss = jstep(variables["params"], variables["batch_stats"],
                       {k: jnp.asarray(v) for k, v in stacked.items()}, jnp.asarray(cw))
    cm, loss = MultiEvalStep(make_eval_step(model, 5), 2)(
        _stacked([_tensors(b) for b in batches]), torch.from_numpy(cw))
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=1e-5, atol=0)
    # a point whose two largest logits lie within 1e-4 may flip either way
    with torch.inference_mode():
        logits = model.eval()(_stacked([_tensors(b) for b in batches])["points"].flatten(0, 1),
                              _stacked([_tensors(b) for b in batches])["colors"].flatten(0, 1))
    top2 = logits.topk(2, dim=-1).values
    near = int(((top2[..., 0] - top2[..., 1]) < 1e-4).sum())
    assert int(np.abs(cm.numpy() - np.asarray(jcm)).sum()) <= 2 * near
    assert int(cm.sum()) == 3 * 64


@pytest.mark.slow
def test_train_matches_jax_train_at_two_steps_a_dispatch(tmp_path):
    """The slice as a whole: the port's train() and the JAX package's, both
    at steps_per_dispatch 2 (3 training batches an epoch: a dispatch and a
    single step; validation likewise, on the EMA weights), pointnet2_ssg at
    narrow sampling and dropout 0 from the same weights (JAX's own init,
    converted), two epochs. Slow: the JAX run compiles four programs (about
    40 s on the CPU).

    Bands: the JAX package's own for its two engines (tests/
    test_multistep.py::test_train_engine_multistep_runs_and_matches), each
    epoch's losses within 2% and accuracies within 5% relative. Adam's first
    step moves every element by lr in its gradient's sign, and 17 train-mode
    BatchNorms make the two float32 gradients differ by percents of a leaf's
    largest (tests/test_torch_train.py), so small gradients flip sign: the
    second step's loss is 0.9% apart here. Every weight within 2 * 3.17 * lr
    * steps of JAX's: Adam moves an element by at most lr * (1 - b1) /
    sqrt(1 - b2) = 3.17 lr a step, either way."""
    blocks, names = _blocks(0, 6)
    vblocks, vnames = _blocks(1, 5)
    jcfg = _config(JaxConfig, 2, "pointnet2_ssg")
    jcfg.train.donate = False
    jtr = JaxBlockDataset.from_blocks(blocks, names)
    jout = jax_train(jcfg, jtr, JaxBlockDataset.from_blocks(vblocks, vnames),
                     exp_dir=str(tmp_path / "jax"))
    # JAX's initial weights, as its train() made them (create_train_state)
    jmodel = jax_get_model("pointnet2_ssg", 5, **jcfg.model.extra)
    sample = next(iter(jtr.batches(2, shuffle=False)))
    init = jax.jit(lambda x, f: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)}, x, f,
        train=False))(jnp.asarray(sample["points"][:1]), jnp.asarray(sample["colors"][:1]))
    cfg = _config(Config, 2, "pointnet2_ssg")
    model = get_model("pointnet2_ssg", 5, **cfg.model.extra)
    model.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, init)),
                          strict=True)
    out = train(cfg, BlockDataset.from_blocks(blocks, names),
                BlockDataset.from_blocks(vblocks, vnames), exp_dir=str(tmp_path / "port"),
                model=model)
    assert len(out["history"]) == len(jout["history"]) == 2
    for got, want in zip(out["history"], jout["history"]):
        for key in ("train_loss", "val_loss"):
            np.testing.assert_allclose(got[key], want[key], rtol=0.02, err_msg=key)
        for key in ("train_acc", "val_acc"):
            np.testing.assert_allclose(got[key], want[key], rtol=0.05, err_msg=key)
    steps = 2 * (6 // 2)
    band = 2 * 3.17 * 1e-3 * steps
    back = dict(jax.tree_util.tree_leaves_with_path(
        state_dict_to_flax(out["model"].state_dict())["params"]))
    for path, leaf in jax.tree_util.tree_leaves_with_path(jout["state"].params):
        err = np.abs(np.asarray(back[path]) - np.asarray(leaf)).max()
        assert err <= band, f"{jax.tree_util.keystr(path)}: {err:.3g} > {band:.3g}"


# ------------------------------------------------------------ capture-safe counts


def _labels_preds_mask(seed=0, c=5, size=(3, 40)):
    rng = np.random.default_rng(seed)
    labels = torch.from_numpy(rng.integers(0, c, size))
    preds = torch.from_numpy(rng.integers(0, c, size))
    mask = torch.from_numpy(rng.uniform(size=size) < 0.7)
    return labels, preds, mask


@pytest.mark.parametrize("c", [2, 5, 13])
def test_confusion_matrices_equal_the_bincount_counts(c):
    """The fixed-length counts against torch.bincount's, masked points
    dropped into the sink bin."""
    labels, preds, mask = _labels_preds_mask(c, c)
    flat = labels.reshape(-1) * c + preds.reshape(-1)
    want = torch.bincount(flat, minlength=c * c).reshape(c, c)
    got = M.confusion_matrix(preds, labels, c)
    assert got.dtype == torch.int64 and torch.equal(got, want)
    sink = torch.where(mask.reshape(-1), flat, c * c)
    want = torch.bincount(sink, minlength=c * c + 1)[:-1].reshape(c, c)
    assert torch.equal(M.masked_confusion_matrix(preds, labels, mask, c), want)
    assert int(M.masked_confusion_matrix(preds, labels, mask, c).sum()) == int(mask.sum())


def test_confusion_matrix_refuses_a_label_out_of_range():
    with pytest.raises((RuntimeError, IndexError)):
        M.confusion_matrix(torch.tensor([0, 1]), torch.tensor([0, 5]), 5)


def _bincount_bridge_structure_weights(preds, labels, xyz, alpha=20.0, rel_margin=0.2,
                                       num_classes=5):
    """losses.py::bridge_structure_weights as it was before its counts were
    made capture-safe: torch.bincount, then the first num_classes bins."""
    labels = labels.long()
    weights = torch.tensor([1.5, 1.0, 1.2, 1.5, 1.0])[None, :].repeat(labels.shape[0], 1)
    exists = {c: (labels == c).any(1) for c in (1, 2, 3, 4)}
    rel = {c: losses._masked_norm_z_mean(xyz.float(), preds == c) for c in (1, 2, 3, 4)}
    for cid in (1, 2, 3, 4):
        for lower in losses._BSL_ABOVE[cid]:
            gate = (exists[cid] & exists[lower]).float()
            violation = torch.relu(-(rel[cid] - rel[lower]) + rel_margin) * gate
            weights[:, cid] += alpha * violation
            weights[:, lower] += alpha * violation * 0.5
            weights[:, lower] += alpha * violation
            weights[:, cid] += alpha * violation * 0.3
    weights[:, 0] += alpha * (1.0 - (preds == 0).float().mean(1))
    counts = torch.bincount(labels.reshape(-1), minlength=num_classes)[:num_classes]
    freq_w = 1.0 / torch.sqrt(torch.clamp(counts.float(), min=1.0))
    freq_w[1] *= 2.0
    freq_w[4] *= 2.0
    return weights.mean(0) * freq_w


@pytest.mark.parametrize("top", [5, 7], ids=["labels_in_range", "labels_past_num_classes"])
def test_bridge_structure_weights_equal_the_bincount_weights(top):
    """bridge_structure_weights bit for bit against its bincount form, on
    random labels and predictions; with labels up to 6 of 5 classes, the
    ones past num_classes dropped as the old slice dropped them."""
    rng = np.random.default_rng(top)
    for _ in range(4):
        labels = torch.from_numpy(rng.integers(0, top, (3, 64)))
        preds = torch.from_numpy(rng.integers(0, 5, (3, 64)))
        xyz = torch.from_numpy(rng.uniform(size=(3, 64, 3)).astype(np.float32))
        got = losses.bridge_structure_weights(preds, labels, xyz, alpha=80.0, rel_margin=0.3)
        want = _bincount_bridge_structure_weights(preds, labels, xyz, 80.0, 0.3)
        assert torch.equal(got, want)


def _numpy_upsample_plan(n_in, n_out, dtype):
    """randlanet.py's plan as it was computed before, in numpy."""
    dt = np.dtype(dtype)
    inv_scale = dt.type(1.0 / (n_out / n_in))
    sample = ((np.arange(n_out, dtype=np.float64) + 0.5) * np.float64(inv_scale)
              - 0.5).astype(dt)
    lo = np.floor(sample).astype(np.int64)
    src = np.stack([lo, lo + 1], axis=1)
    w = np.maximum(dt.type(0), dt.type(1) - np.abs(sample[:, None] - src.astype(dt)))
    w = np.where((src >= 0) & (src < n_in), w, dt.type(0)).astype(dt)
    w = (w / (w[:, :1] + w[:, 1:])).astype(dt)
    return np.clip(src, 0, n_in - 1), w


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_upsample_plan_made_on_the_device_is_the_numpy_plan(dtype):
    """RandLA-Net's linear-upsampling plan, now made by torch ops on the
    input's device (no copy from the host), bit for bit the numpy plan at
    RandLA-Net's ratios and at odd sizes."""
    name = str(dtype).removeprefix("torch.")
    for n_in, n_out in ((1, 4), (3, 7), (16, 64), (64, 256), (256, 1024), (1024, 4096),
                        (17, 67), (33, 33), (5, 4096), (1000, 1001)):
        src, w = _upsample_plan(n_in, n_out, dtype, "cpu")
        want_src, want_w = _numpy_upsample_plan(n_in, n_out, name)
        assert np.array_equal(src.numpy(), want_src)
        assert w.dtype == dtype and np.array_equal(w.numpy().view(np.uint8),
                                                   want_w.view(np.uint8)), (n_in, n_out)


# ------------------------------------------------------------ utilities


def test_set_random_seed_repeats_every_generator():
    try:
        draws = []
        for _ in range(2):
            g = set_random_seed(7)
            assert torch.are_deterministic_algorithms_enabled()
            assert torch.is_deterministic_algorithms_warn_only_enabled()
            import random

            draws.append((random.random(), np.random.rand(3), torch.rand(3),
                          torch.rand(3, generator=g)))
        for a, b in zip(*draws):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        g = set_random_seed(8, deterministic=False)
        assert not torch.are_deterministic_algorithms_enabled()
        assert not torch.equal(torch.rand(3, generator=g), draws[0][3])
    finally:
        set_random_seed(0, deterministic=False)


def test_span_points_per_second_and_device_time_on_the_cpu():
    sink = {}
    with span("x", sink):
        pass
    with span("x", sink):
        pass
    assert set(sink) == {"x"} and sink["x"] >= 0.0

    calls = []

    def fn(x):
        calls.append(1)
        return (x @ x.transpose(1, 2)).sum(-1)

    xyz = torch.ones(2, 64, 3)
    t = device_time(fn, xyz, iters=4, reps=3)
    assert t > 0 and len(calls) == 1 + 4 * 3
    assert points_per_second(fn, xyz, iters=4) > 0
    with pytest.raises(ValueError, match="positive"):
        device_time(fn, xyz, iters=0)
    if not torch.cuda.is_available():
        assert live_memory() == {}
