"""Ranks of ``torch.distributed`` on the CPU for the port's parallel tests.

``Ranks(job, world, tmp).start()`` runs ``world`` processes of this file
(``python tests/torch_ranks.py JOB RANK WORLD DIR``), each one torch
thread, joined in a gloo group through a ``FileStore`` under ``DIR`` (no
port to collide between xdist workers). Each runs the job of that name
(below; they import the port alone, never JAX), which returns a dict that
the process saves as ``DIR/rank<r>.pt``; ``join`` loads them, in rank
order. A rank that fails or outlives the timeout fails the join, with the
end of each rank's stderr, and the processes are killed: a hung collective
fails one test, not the tier. The builders below make the same seeded
models and batches in the ranks and in the tests, which carry the weights
to the JAX package through ``utils/weights.py``.
"""

import os
import subprocess
import sys
import time
from datetime import timedelta

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
JOBS = {}

SA_NPOINTS = (32, 16, 8)
CLASS_WEIGHTS = np.array([0.7, 1.3, 2.0, 0.5, 1.1], np.float32)


def job(fn):
    """Register ``fn(rank, world, dir) -> dict`` as a job by its name."""
    JOBS[fn.__name__] = fn
    return fn


class Ranks:
    def __init__(self, job: str, world: int, tmp, timeout: float = 120.0):
        self.job, self.world = job, world
        self.dir, self.timeout = str(tmp), timeout
        self.procs = []

    def start(self) -> "Ranks":
        os.makedirs(self.dir, exist_ok=True)
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join([REPO, HERE, os.environ.get("PYTHONPATH", "")]))
        for r in range(self.world):
            err = open(os.path.join(self.dir, f"rank{r}.err"), "w")
            self.procs.append(subprocess.Popen(
                [sys.executable, os.path.join(HERE, "torch_ranks.py"), self.job,
                 str(r), str(self.world), self.dir],
                stdout=err, stderr=subprocess.STDOUT, cwd=REPO, env=env))
        self.started = time.monotonic()
        return self

    def join(self) -> list:
        failed = []
        for r, p in enumerate(self.procs):
            left = max(1.0, self.timeout - (time.monotonic() - self.started))
            try:
                if p.wait(timeout=left):
                    failed.append(r)
            except subprocess.TimeoutExpired:
                failed.append(r)
        if failed:
            for p in self.procs:
                p.kill()
            logs = "\n".join(
                f"--- rank {r}:\n" + open(os.path.join(self.dir, f"rank{r}.err")).read()[-3000:]
                for r in range(self.world))
            raise AssertionError(f"ranks {failed} of '{self.job}' failed or timed out\n{logs}")
        return [torch.load(os.path.join(self.dir, f"rank{r}.pt"), weights_only=False)
                for r in range(self.world)]


def _main(name, rank, world, path):
    import torch.distributed as dist

    torch.set_num_threads(1)
    fn = JOBS[name]
    store = dist.FileStore(os.path.join(path, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=timedelta(seconds=90))
    try:
        out = fn(rank, world, path)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(path, f"rank{rank}.pt"))


# ------------------------------------------------------------------ builders


def ssg(seed: int = 0, axis_name=None, **kw):
    """The port's SSG at the tests' size, its weights drawn from ``seed``
    and its BatchNorms moved away from the identity, dropout off."""
    from pointcloud_bridge_tpu_torch.models import get_model

    gen = torch.Generator().manual_seed(seed)
    model = get_model("pointnet2_ssg", 5, sa_npoints=SA_NPOINTS, dropout_rate=0.0,
                      generator=gen, axis_name=axis_name, **kw)
    randomize_bn(model, gen)
    return model


def randomize_bn(model, gen):
    from pointcloud_bridge_tpu_torch.models import BatchNorm

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.uniform_(-0.2, 0.2, generator=gen)
                m.running_mean.uniform_(-0.1, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)


def skewed_batch(b: int = 4, n: int = 128, seed: int = 0):
    """A batch whose first half draws its labels from classes 0-1 and its
    second half from 2-4: two ranks see different label mixes, so the mean
    of their weighted losses is not the global batch's weighted loss."""
    rng = np.random.default_rng(seed)
    labels = np.concatenate([rng.integers(0, 2, (b // 2, n)), rng.integers(2, 5, (b - b // 2, n))])
    return {
        "points": rng.uniform(size=(b, n, 3)).astype(np.float32),
        "colors": rng.uniform(size=(b, n, 3)).astype(np.float32),
        "labels": labels.astype(np.int32),
        "mask": np.ones(b, bool),
        "block_ids": np.arange(b, dtype=np.int32),
    }


def grads_of(model):
    return {k: p.grad.detach().clone() for k, p in model.named_parameters()}


def state_of(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


SGD_LR = 0.1
ADAM_LR = 1e-3
EMA_DECAY = 0.9


def _setup():
    from pointcloud_bridge_tpu_torch.config import Config

    return Config().loss, torch.from_numpy(CLASS_WEIGHTS)


def stacked(*batches):
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def padded_batches(n_blocks: int, batch_size: int = 4, n: int = 64):
    """The eval batches of a dataset of ``n_blocks`` blocks (the last one
    padded, its mask marking the real rows)."""
    from pointcloud_bridge_tpu_torch.data import BlockDataset

    rng = np.random.default_rng(n_blocks)
    ds = BlockDataset(
        points=rng.uniform(size=(n_blocks, n, 3)).astype(np.float32),
        colors=rng.uniform(size=(n_blocks, n, 3)).astype(np.float32),
        labels=rng.integers(0, 5, (n_blocks, n)).astype(np.int32),
        original_points=np.zeros((n_blocks, n, 3), np.float32),
        indices=np.zeros((n_blocks, n), np.int64), file_ids=np.zeros(n_blocks, np.int64),
        file_names=["toy"])
    return list(ds.batches(batch_size, shuffle=False, drop_last=False))


@job
def dp(rank, world, path):
    """The dp train step (plain SGD, then Adam), the dp eval step on a
    masked batch and on padded tails, and rank 1's weights replicated from
    rank 0's."""
    from pointcloud_bridge_tpu_torch.parallel import (
        make_dp_eval_step, make_dp_train_step, make_mesh, replicate, shard_batch)
    from pointcloud_bridge_tpu_torch.train import make_optimizer

    loss_cfg, cw = _setup()
    mesh = make_mesh(world)
    local = shard_batch(skewed_batch(), mesh)
    out = {}
    model = ssg(0, "data")
    if rank:
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
    sgd = torch.optim.SGD(model.parameters(), lr=SGD_LR)
    replicate(model, sgd)
    out["replicated"] = state_of(model)
    m = make_dp_train_step(model, loss_cfg, sgd, mesh)(local, SGD_LR, cw)
    out.update(loss=float(m["loss"]), acc=float(m["acc"]), grads=grads_of(model),
               state=state_of(model))

    model = ssg(0, "data")
    opt = make_optimizer(model.parameters(), 1e-4)
    before = state_of(model)
    make_dp_train_step(model, loss_cfg, opt, mesh)(local, ADAM_LR, cw)
    out["adam"] = {"before": before, "grads": grads_of(model), "after": state_of(model)}

    evb = skewed_batch(4, 128, seed=5)
    evb["mask"][3] = False
    step = make_dp_eval_step(ssg(0, "data"), 5, mesh)
    cm, loss = step(shard_batch(evb, mesh), cw)
    out["eval"] = (cm.clone(), float(loss))
    out["padded"] = {}
    for n_blocks in (1, 2, 3):
        (b,) = padded_batches(n_blocks)
        cm, loss = step(shard_batch(b, mesh), cw)
        out["padded"][n_blocks] = (b, cm.clone(), float(loss))
    return out


@job
def multi(rank, world, path):
    """K = 2 dp steps a dispatch with the EMA, and the same two steps as
    single dp steps."""
    from pointcloud_bridge_tpu_torch.parallel import (
        make_dp_multi_train_step, make_dp_train_step, make_mesh, shard_batch)
    from pointcloud_bridge_tpu_torch.train.loop import ema_update

    loss_cfg, cw = _setup()
    mesh = make_mesh(world)
    both = shard_batch(stacked(skewed_batch(seed=1), skewed_batch(seed=2)), mesh, dim=1)
    model = ssg(0, "data")
    ema = {k: p.detach().clone() for k, p in model.named_parameters()}
    step = make_dp_multi_train_step(model, loss_cfg, torch.optim.SGD(model.parameters(), SGD_LR),
                                    mesh, 2, ema=ema, ema_decay=EMA_DECAY)
    m = step(both, SGD_LR, cw)
    out = {"loss": m["loss"].clone(), "acc": m["acc"].clone(), "state": state_of(model),
           "ema": {k: v.clone() for k, v in ema.items()}}
    model = ssg(0, "data")
    params = dict(model.named_parameters())
    ema = {k: p.detach().clone() for k, p in params.items()}
    single = make_dp_train_step(model, loss_cfg, torch.optim.SGD(model.parameters(), SGD_LR), mesh)
    losses = []
    for i in range(2):
        losses.append(single({k: v[i] for k, v in both.items()}, SGD_LR, cw)["loss"].clone())
        ema_update(ema, params, EMA_DECAY)
    out["single"] = {"loss": torch.stack(losses), "state": state_of(model), "ema": ema}
    return out


@job
def tp(rank, world, path):
    """One tp step (plain SGD) on a 2 x 2 mesh, gathered back to the
    single-device layout, and the local shapes of the split kernels."""
    from pointcloud_bridge_tpu_torch.parallel import make_2d_mesh, make_tp_train_step
    from pointcloud_bridge_tpu_torch.parallel.sharding import full_tensors, param_shardings

    loss_cfg, cw = _setup()
    mesh = make_2d_mesh(2, world // 2)
    model = ssg(0, "data")
    full_shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    step, place = make_tp_train_step(model, loss_cfg, torch.optim.SGD(model.parameters(), SGD_LR),
                                     mesh)
    local = place(skewed_batch())
    sharded = [k for k, v in param_shardings(model, mesh).items() if v]
    m = step(local, SGD_LR, cw)
    return {"loss": float(m["loss"]), "acc": float(m["acc"]), "sharded": sharded,
            "local_shapes": {k: tuple(p.shape) for k, p in model.named_parameters()},
            "full_shapes": full_shapes,
            "grads": full_tensors(model, grads_of(model), mesh),
            "state": full_tensors(model, state_of(model), mesh)}


@job
def fsdp(rank, world, path):
    """One fsdp step (plain SGD), then two Adam steps: the state gathered
    back to the single-device layout, and the share of every large leaf and
    moment this rank holds after each."""
    from torch.distributed.tensor import DTensor

    from pointcloud_bridge_tpu_torch.parallel import (
        fsdp_state_shardings, make_fsdp_mesh, make_fsdp_train_step)
    from pointcloud_bridge_tpu_torch.parallel.fsdp import full_state_dict
    from pointcloud_bridge_tpu_torch.train import make_optimizer

    loss_cfg, cw = _setup()
    mesh = make_fsdp_mesh(world)

    def full_grads(model):
        return {k: p.grad.full_tensor() if isinstance(p.grad, DTensor) else p.grad.clone()
                for k, p in model.named_parameters()}

    model = ssg(0, "data")
    sgd = torch.optim.SGD(model.parameters(), SGD_LR)
    step, place = make_fsdp_train_step(model, loss_cfg, sgd, mesh)
    local = place(skewed_batch())
    m = step(local, SGD_LR, cw)
    out = {"loss": float(m["loss"]), "acc": float(m["acc"]), "grads": full_grads(model),
           "state": full_state_dict(model)}

    model = ssg(0, "data")
    opt = make_optimizer(model.parameters(), 1e-4)
    step, place = make_fsdp_train_step(model, loss_cfg, opt, mesh)
    local = place(skewed_batch())
    adam = []
    for i in range(2):
        before = full_state_dict(model)
        step(local if i == 0 else place(skewed_batch(seed=3)), ADAM_LR, cw)
        adam.append({"before": before, "grads": full_grads(model), "after": full_state_dict(model),
                     "shares": fsdp_state_shardings(model, opt),
                     "dtensors": all(isinstance(p, DTensor) for p in model.parameters())})
    out["adam"] = adam
    return out


BN_POINTS = 64


def seeded(name: str, axis_name=None):
    """Registry model ``name`` drawn from a seed, in train mode with its
    draws switched off (dropout 0, RandLA-Net's stride subsets)."""
    import inspect

    from pointcloud_bridge_tpu_torch.models import Dropout, get_model
    from pointcloud_bridge_tpu_torch.models.registry import MODEL_REGISTRY

    # the classifiers default to xyz alone: every model takes the colours
    kw = {"in_features": 3} if "in_features" in inspect.signature(MODEL_REGISTRY[name]).parameters \
        else {}
    if name == "ptv3_moe":  # a capacity that drops no token routes each alone
        kw["moe_capacity_factor"] = 8.0
    model = get_model(name, 5, generator=torch.Generator().manual_seed(7), axis_name=axis_name,
                      **kw)
    randomize_bn(model, torch.Generator().manual_seed(8))
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
        if hasattr(m, "sampling_generator"):
            m.sampling_generator = None
    return model.train()


def bn_buffers(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def registry_models():
    """One registry name for each distinct model: the names whose entries
    build the same model (the aliases) share its result."""
    from pointcloud_bridge_tpu_torch.models.registry import MODEL_REGISTRY

    first = {}
    for name, entry in MODEL_REGISTRY.items():
        key = (getattr(entry, "func", entry), getattr(entry, "args", ()),
               tuple(sorted(getattr(entry, "keywords", {}).items())))
        first.setdefault(key, name)
    return {name: first[key] for name, key in (
        (n, (getattr(e, "func", e), getattr(e, "args", ()),
             tuple(sorted(getattr(e, "keywords", {}).items()))))
        for n, e in MODEL_REGISTRY.items())}


def small(name: str, axis_name=None):
    """SSG and BriStruNet at the JAX comparison's size."""
    from pointcloud_bridge_tpu_torch.models import get_model

    model = get_model(name, 5, generator=torch.Generator().manual_seed(7), axis_name=axis_name,
                      sa_npoints=SA_NPOINTS, dropout_rate=0.0)
    randomize_bn(model, torch.Generator().manual_seed(8))
    return model.train()


def fast_edgeconv(axis_name=None):
    """One EdgeConv (C = 16, F = 24, k = 8) and its BatchNorm drawn from a
    seed, in train mode, the BatchNorm synced over ``axis_name``."""
    from pointcloud_bridge_tpu_torch.models import BatchNorm, EdgeConv

    holder = torch.nn.Module()
    holder.edge = EdgeConv(16, 24, 8, torch.Generator().manual_seed(3))
    holder.bn = BatchNorm(24)
    randomize_bn(holder, torch.Generator().manual_seed(4))
    holder.bn.axis_name = axis_name
    return holder.train()


def _fast_edgeconv_run(rank: int) -> dict:
    """The restructured EdgeConv (PCB_EDGECONV_FAST=1) synced over "data"
    on this rank's 2 of 4 clouds; rank 0 also over all 4 synced over a
    group of itself alone, rank 1 over all 4 unsynced."""
    from pointcloud_bridge_tpu_torch.models import dgcnn

    x = torch.from_numpy(np.random.default_rng(10).normal(size=(4, 64, 16)).astype(np.float32))
    os.environ["PCB_EDGECONV_FAST"] = "1"
    try:
        h = fast_edgeconv("data")
        res = {"logits": h.edge(x[2 * rank:2 * rank + 2], h.bn).detach(),
               "stats": bn_buffers(h), "fast": dgcnn._edgeconv_fast_default(x)}
        key, axis = ("alone", "alone") if rank == 0 else ("single", None)
        h = fast_edgeconv(axis)
        res[key] = {"logits": h.edge(x, h.bn).detach(), "stats": bn_buffers(h)}
    finally:
        del os.environ["PCB_EDGECONV_FAST"]
    return res


@job
def bn(rank, world, path):
    """A train-mode forward of each distinct registry model built with
    axis_name="data" on this rank's rows, and of SSG and BriStruNet at the
    JAX comparison's size. Rank 0 also forwards the whole batch through
    the same model synced over a group of itself alone (the same
    arithmetic in a world of one), rank 1 through the model built without
    axis_name. Then the restructured EdgeConv alone (_fast_edgeconv_run)."""
    import torch.distributed as dist

    from pointcloud_bridge_tpu_torch.parallel import make_mesh, shard_batch
    from pointcloud_bridge_tpu_torch.utils.collectives import bind_axis

    mesh = make_mesh(world)
    bind_axis("alone", [dist.new_group([r]) for r in range(world)][rank])
    b = skewed_batch(4, BN_POINTS, seed=9)
    local = shard_batch(b, mesh)
    whole = {k: torch.from_numpy(b[k]) for k in ("points", "colors")}
    out = {}
    builds = {name: seeded for name in sorted(set(registry_models().values()))}
    builds.update({"small:pointnet2_ssg": small, "small:bristrunet": small})
    for name, build in builds.items():
        arch = name.split(":")[-1]
        model = build(arch, "data")
        res = {"logits": model(local["points"], local["colors"]).detach(),
               "stats": bn_buffers(model)}
        key, axis = ("alone", "alone") if rank == 0 else ("single", None)
        model = build(arch, axis)
        res[key] = {"logits": model(whole["points"], whole["colors"]).detach(),
                    "stats": bn_buffers(model)}
        out[name] = res
    out["fast_edgeconv"] = _fast_edgeconv_run(rank)
    return out


def engine_config(path, **parallel):
    from pointcloud_bridge_tpu_torch.config import Config

    cfg = Config.from_dict({"num_classes": 5, "batch_size": 4, "num_epochs": 1,
                            "num_points": 128})
    cfg.data.train_dir = cfg.data.val_dir = os.path.join(path, "..", "scenes")
    cfg.data.sampler = "random"
    cfg.device = "cpu"
    cfg.exp_dir_root = os.path.join(path, "experiments")
    cfg.parallel.num_devices = -1
    for k, v in parallel.items():
        setattr(cfg.train if k in ("accum_steps", "steps_per_dispatch", "batch_size")
                else cfg.parallel, k, v)
    return cfg


@job
def engine(rank, world, path):
    """train() in dp over the ranks for one epoch at the registry's SSG
    (rank 0 writes the checkpoints), tp and fsdp with the EMA for one epoch
    at the tests' SSG, dp at steps_per_dispatch 2 and 1 and a resumed
    second epoch, and the refusals of the trainer's mesh, each raised before
    any collective."""
    from pointcloud_bridge_tpu_torch.train import train
    from pointcloud_bridge_tpu_torch.train_cli import build_datasets

    # the scalar writer's TensorBoard import pulls in TensorFlow, ~15 s a
    # process: the ranks keep to its CSV, which is what the tests read
    sys.modules["torch.utils.tensorboard"] = None
    out = {"refusals": {}}
    cases = {
        "batch": dict(batch_size=3), "tp_axis": dict(mode="tp", tp_axis_size=3),
        "fsdp_accum": dict(mode="fsdp", accum_steps=2), "dp_accum": dict(accum_steps=2),
        "tp_dispatch": dict(mode="tp", steps_per_dispatch=2),
        "fsdp_dispatch": dict(mode="fsdp", steps_per_dispatch=2),
        "sp": dict(mode="sp", accum_steps=2), "pp": dict(mode="pp", steps_per_dispatch=2),
        "ep": dict(mode="ep"),
    }
    for name, kw in cases.items():
        cfg = engine_config(path, **kw)
        try:
            train(cfg, None, None, exp_dir=os.path.join(path, "refused"))
            out["refusals"][name] = None
        except (ValueError, NotImplementedError) as e:
            out["refusals"][name] = f"{type(e).__name__}: {e}"
    cfg = engine_config(path)
    tr, va = build_datasets(cfg)
    for mode in ("dp", "tp", "fsdp"):
        cfg = engine_config(path, mode=mode, tp_axis_size=2)
        if mode != "dp":  # the EMA in the split layouts too
            cfg.model.extra = {"sa_npoints": SA_NPOINTS}
            cfg.train.ema_decay = 0.9
        res = train(cfg, tr, va, exp_dir=os.path.join(path, f"exp_{mode}"))
        out[mode] = {"history": res["history"], "exp_dir": res["exp_dir"],
                     "state": res["state"]["model"]}
    # sp at the registry's SSG (queries sliced over the ranks), pp of the
    # registry's ptv3 over two stages and ep of its ptv3_moe on a 1 x 2
    # mesh, the last two with the EMA
    for mode, name in (("sp", "pointnet2_ssg"), ("pp", "ptv3"), ("ep", "ptv3_moe")):
        cfg = engine_config(path, mode=mode, ep_axis_size=2)
        cfg.model.name = name
        if mode != "sp":
            cfg.train.ema_decay = 0.9
        res = train(cfg, tr, va, exp_dir=os.path.join(path, f"exp_{mode}"))
        out[mode] = {"history": res["history"], "exp_dir": res["exp_dir"],
                     "state": res["state"]["model"]}
    # dp at two steps a dispatch (eager on the CPU) against one, at the
    # tests' SSG; then one more epoch of the latter, resumed from its
    # checkpoint
    for spd in (1, 2):
        cfg = engine_config(path, steps_per_dispatch=spd)
        cfg.model.extra = {"sa_npoints": SA_NPOINTS}
        res = train(cfg, tr, va, exp_dir=os.path.join(path, f"exp_spd{spd}"))
        out[f"spd{spd}"] = {"history": res["history"], "state": res["state"]["model"]}
    cfg = engine_config(path)
    cfg.model.extra = {"sa_npoints": SA_NPOINTS}
    cfg.train.num_epochs = 2
    res = train(cfg, tr, va, exp_dir=os.path.join(path, "exp_spd1"), resume=True)
    out["resumed"] = {"history": res["history"], "state": res["state"]["model"]}
    return out


# ------------------------------------------------------------ part 2: sp, pp, ep


RING_SHAPE = (2, 64, 2, 32)  # B, N, H, D


def ring_inputs():
    """q, k, v and an output cotangent of RING_SHAPE, float32, from a seed."""
    rng = np.random.default_rng(21)
    return [rng.normal(size=RING_SHAPE).astype(np.float32) * s for s in (2.0, 2.0, 1.0, 1.0)]


@job
def ring(rank, world, path):
    """ring_attention and ring_attention_plain on this rank's slice of N,
    with the gradients of <out, cotangent>; then ring_attention on bf16
    inputs."""
    from pointcloud_bridge_tpu_torch.parallel import make_mesh, ring_attention
    from pointcloud_bridge_tpu_torch.parallel.ring import ring_attention_plain

    make_mesh(world, "sp")
    n = RING_SHAPE[1] // world
    rows = slice(rank * n, (rank + 1) * n)
    q, k, v, g = (torch.from_numpy(a[:, rows].copy()) for a in ring_inputs())
    out = {}
    for name, fn in (("ring", ring_attention), ("plain", ring_attention_plain)):
        qkv = [t.clone().requires_grad_() for t in (q, k, v)]
        o = fn(*qkv, "sp")
        (o * g).sum().backward()
        out[name] = {"out": o.detach(), "grads": [t.grad for t in qkv]}
    bf = ring_attention(*(t.bfloat16() for t in (q, k, v)), "sp")
    out["bf16"] = bf.float() if bf.dtype == torch.bfloat16 else None
    return out


# name -> (registry name, model kwargs, shard_inputs, B, N)
SP_CASES = {
    "ptv3": ("ptv3", dict(embed_dim=64, depth=2, num_heads=2), True, 4, 64),
    "windowed_ptv3": ("ptv3", dict(embed_dim=64, depth=2, num_heads=2, window_size=16), False,
                      4, 64),
    "ptv3_pooled": ("ptv3_pooled", dict(dims=(32, 32, 32), enc_depths=(1, 1, 1),
                                        dec_depths=(1, 1), strides=(4, 4), window_size=8),
                    False, 2, 128),
    "pointnet2_ssg": ("pointnet2_ssg", dict(sa_npoints=SA_NPOINTS), False, 4, 64),
    "pointnet2_msg": ("pointnet2_msg", dict(), False, 1, 1280),
    "bristrunet": ("bristrunet", dict(sa_npoints=SA_NPOINTS), False, 2, 64),
}
SP_PTV3 = ("ptv3", "windowed_ptv3", "ptv3_pooled")
SP_POINTNET = ("pointnet2_ssg", "pointnet2_msg")


def sp_model(case: str, **axes):
    """SP_CASES[case]'s model drawn from a seed, its BatchNorms moved, its
    Dropouts off, in train mode."""
    from pointcloud_bridge_tpu_torch.models import Dropout, get_model

    name, kw, *_ = SP_CASES[case]
    model = get_model(name, 5, generator=torch.Generator().manual_seed(7), **kw, **axes)
    randomize_bn(model, torch.Generator().manual_seed(8))
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return model.train()


def n_skewed_batch(b: int, n: int, seed: int = 0):
    """A batch whose first half of every cloud's points draws its labels
    from classes 0-1 and whose second half from 2-4: shards of the N axis
    see different label mixes."""
    rng = np.random.default_rng(seed)
    labels = np.concatenate([rng.integers(0, 2, (b, n // 2)), rng.integers(2, 5, (b, n - n // 2))],
                            axis=1)
    return {"points": rng.uniform(size=(b, n, 3)).astype(np.float32),
            "colors": rng.uniform(size=(b, n, 3)).astype(np.float32),
            "labels": labels.astype(np.int32), "mask": np.ones(b, bool)}


def _sp_run(case, mesh, dp_axis=None):
    from pointcloud_bridge_tpu_torch.parallel import (
        make_sp_eval_step, make_sp_forward, make_sp_train_step, shard_sp_batch)

    loss_cfg, cw = _setup()
    _, _, shard, b, n = SP_CASES[case]
    axis_name = ("data", "sp") if dp_axis else "sp"
    model = sp_model(case, sp_axis="sp", axis_name=axis_name)
    local = shard_sp_batch(n_skewed_batch(b, n), mesh, "sp", dp_axis, shard, device="cpu")
    out = {}
    if not dp_axis:
        out["forward"] = make_sp_forward(model)(local["points"], local["colors"])
        cm, loss = make_sp_eval_step(model, 5, "sp", shard)(local, cw)
        out["eval"] = (cm.clone(), float(loss))
    step = make_sp_train_step(model, loss_cfg, torch.optim.SGD(model.parameters(), SGD_LR),
                              "sp", dp_axis)
    m = step(local, SGD_LR, cw)
    out.update(loss=float(m["loss"]), acc=float(m["acc"]), grads=grads_of(model),
               stats=bn_buffers(model))
    return out


@job
def sp(rank, world, path):
    """One sp train step (plain SGD) of each PTv3 model of SP_CASES over a
    mesh of the world, with its eval step and forward, the multi-step, then
    ptv3 on a 2 x (world / 2) ("data", "sp") mesh."""
    from pointcloud_bridge_tpu_torch.parallel import make_mesh, make_named_mesh

    mesh = make_mesh(world, "sp")
    out = {case: _sp_run(case, mesh) for case in SP_PTV3}
    out["multi"] = _sp_multi(mesh)
    out["dp_x_sp"] = _sp_run("ptv3", make_named_mesh((2, world // 2), ("data", "sp")), "data")
    return out


def _sp_cases(world, cases) -> dict:
    from pointcloud_bridge_tpu_torch.parallel import make_mesh

    mesh = make_mesh(world, "sp")
    return {case: _sp_run(case, mesh) for case in cases}


@job
def sp_pointnet(rank, world, path):
    """The sp job's step, eval step and forward for SSG and MSG (queries
    sliced, inputs whole)."""
    return _sp_cases(world, SP_POINTNET)


@job
def sp_bristrunet(rank, world, path):
    """The same for BriStruNet."""
    return _sp_cases(world, ("bristrunet",))


def _sp_multi(mesh) -> dict:
    """K = 2 sp steps of global ptv3 a dispatch with the EMA, and the same
    two batches as single sp steps."""
    from pointcloud_bridge_tpu_torch.parallel import (
        make_sp_multi_train_step, make_sp_train_step, shard_sp_batch)
    from pointcloud_bridge_tpu_torch.train.loop import ema_update

    loss_cfg, cw = _setup()
    _, _, shard, b, n = SP_CASES["ptv3"]
    both = stacked(n_skewed_batch(b, n, seed=1), n_skewed_batch(b, n, seed=2))
    local = shard_sp_batch(both, mesh, "sp", None, shard, dim=1, device="cpu")
    model = sp_model("ptv3", sp_axis="sp", axis_name="sp")
    ema = {k: p.detach().clone() for k, p in model.named_parameters()}
    m = make_sp_multi_train_step(model, loss_cfg, torch.optim.SGD(model.parameters(), SGD_LR),
                                 2, "sp", ema=ema, ema_decay=EMA_DECAY)(local, SGD_LR, cw)
    out = {"loss": m["loss"].clone(), "state": state_of(model), "ema": ema}
    model = sp_model("ptv3", sp_axis="sp", axis_name="sp")
    params = dict(model.named_parameters())
    ema = {k: p.detach().clone() for k, p in params.items()}
    step = make_sp_train_step(model, loss_cfg, torch.optim.SGD(model.parameters(), SGD_LR), "sp")
    losses = []
    for i in range(2):
        losses.append(step({k: v[i] for k, v in local.items()}, SGD_LR, cw)["loss"].clone())
        ema_update(ema, params, EMA_DECAY)
    out["single"] = {"loss": torch.stack(losses), "state": state_of(model), "ema": ema}
    return out


PP_KW = dict(embed_dim=64, depth=4, num_heads=2)


def pp_model(window: int = 0, **axes):
    """ptv3 of PP_KW (four blocks), drawn from a seed, dropout off."""
    from pointcloud_bridge_tpu_torch.models import Dropout, get_model

    model = get_model("ptv3", 5, generator=torch.Generator().manual_seed(11), window_size=window,
                      **PP_KW, **axes)
    randomize_bn(model, torch.Generator().manual_seed(12))
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return model.train()


def _pp_run(mesh, window=0, dp_axis=None, adam=False):
    from pointcloud_bridge_tpu_torch.parallel import (
        make_pp_forward, make_pp_state, make_pp_train_step, pp_place_state)
    from pointcloud_bridge_tpu_torch.parallel.mesh import shard_batch
    from pointcloud_bridge_tpu_torch.train import make_optimizer
    from pointcloud_bridge_tpu_torch.train.loop import batch_to_device

    loss_cfg, cw = _setup()
    batch = skewed_batch(4, 64)
    local = shard_batch(batch, mesh, dp_axis) if dp_axis else batch_to_device(batch, "cpu")
    model = pp_model(window, **({"axis_name": dp_axis} if dp_axis else {}))
    out = {}
    if not (dp_axis or adam):
        out["forward"] = make_pp_forward(model, mesh, "pp", 2)(local["points"], local["colors"])
    opt = make_optimizer(model.parameters(), 1e-4) if adam else torch.optim.SGD(
        model.parameters(), SGD_LR)
    step, stages = make_pp_train_step(model, loss_cfg, opt, mesh, "pp", 2, dp_axis)
    m = step(local, ADAM_LR if adam else SGD_LR, cw)
    out.update(loss=float(m["loss"]), acc=float(m["acc"]),
               local=sorted(k for k, _ in model.named_parameters()),
               grads=stages.full_tensors(grads_of(model)), state=stages.full_state())
    if adam:
        out["optimizer"] = stages.full_optimizer_state(opt)
        whole = pp_model()
        whole.load_state_dict(out["state"])
        whole_opt = torch.optim.Adam(whole.parameters())
        whole_opt.load_state_dict(out["optimizer"])
        out["stacked"] = {"stage": stages.stacked_state(optimizer=opt),
                          "placed": pp_place_state(make_pp_state(whole, whole_opt), mesh)}
    return out


@job
def pp(rank, world, path):
    """pp train steps of ptv3 over a pipeline of the world's ranks (M = 2):
    global attention (with its eval forward), windowed (Morton-sorted),
    and an Adam step gathered back with its moments; then a 2 x (world /
    2) ("data", "pp") mesh."""
    from pointcloud_bridge_tpu_torch.parallel import make_mesh, make_named_mesh

    mesh = make_mesh(world, "pp")
    out = {"global": _pp_run(mesh), "morton": _pp_run(mesh, window=16),
           "adam": _pp_run(mesh, adam=True)}
    out["dp_x_pp"] = _pp_run(make_named_mesh((2, world // 2), ("data", "pp")), dp_axis="data")
    out["refusals"] = _pp_refusals(make_mesh(world, "pp"))
    return out


def _pp_refusals(mesh) -> dict:
    """The JAX step's refusals (pp.py:64-69, 153-156, 158-162, 221-224):
    each message, raised before any collective."""
    from pointcloud_bridge_tpu_torch.models import get_model
    from pointcloud_bridge_tpu_torch.parallel import make_pp_train_step
    from pointcloud_bridge_tpu_torch.train.loop import batch_to_device

    loss_cfg, cw = _setup()
    cases = {
        "depth": lambda: get_model("ptv3", 5, embed_dim=32, depth=3, num_heads=2),
        "sp_axis": lambda: get_model("ptv3", 5, embed_dim=32, depth=4, num_heads=2, sp_axis="pp"),
        "moe": lambda: get_model("ptv3_moe", 5, embed_dim=32, depth=4, num_heads=2,
                                 num_experts=2),
        "batch": lambda: pp_model(),
    }
    out = {}
    for name, build in cases.items():
        model = build()
        try:
            step, _ = make_pp_train_step(model, loss_cfg, torch.optim.SGD(model.parameters(), 0.0),
                                         mesh, "pp", 2)
            step(batch_to_device(skewed_batch(3, 64), "cpu"), 0.0, cw)
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


EP_KW = dict(embed_dim=64, depth=2, num_heads=2, num_experts=4)
EP_AUX = 1e-2


def ep_model(**axes):
    """ptv3_moe of EP_KW (block 1 routes to 4 experts, top 2, capacity
    1.25: some choices drop), drawn from a seed, dropout off."""
    from pointcloud_bridge_tpu_torch.models import Dropout, get_model

    model = get_model("ptv3_moe", 5, generator=torch.Generator().manual_seed(13), **EP_KW,
                      **axes)
    randomize_bn(model, torch.Generator().manual_seed(14))
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return model.train()


def _ep_run(dp: int, ep: int, n: int = 256) -> dict:
    from pointcloud_bridge_tpu_torch.parallel import make_ep_mesh, make_ep_train_step
    from pointcloud_bridge_tpu_torch.parallel.ep import full_tensors

    loss_cfg, cw = _setup()
    mesh = make_ep_mesh(dp, ep)
    model = ep_model(axis_name="data")
    step, place = make_ep_train_step(model, loss_cfg, torch.optim.SGD(model.parameters(), SGD_LR),
                                     mesh, EP_AUX)
    try:
        m = step(place(skewed_batch(4, n)), SGD_LR, cw)
    except ValueError as e:
        return {"refused": str(e)}
    return {"loss": float(m["loss"]), "aux_loss": float(m["aux_loss"]), "acc": float(m["acc"]),
            "local": {k: tuple(p.shape) for k, p in model.named_parameters()},
            "grads": full_tensors(model, mesh, grads_of(model)),
            "state": full_tensors(model, mesh, state_of(model))}


@job
def ep(rank, world, path):
    """One ep train step (plain SGD) of ptv3_moe on a 1 x 2 and a 2 x 1
    ("data", "expert") mesh, a 2 x 1 step whose ranks would split a token
    group, and the whole-scene vote over a "data" mesh of the world
    beside the single-rank vote."""
    from pointcloud_bridge_tpu_torch.data.blocks import scene_labelweights
    from pointcloud_bridge_tpu_torch.data.synthetic import toy_bridge_scene
    from pointcloud_bridge_tpu_torch.infer.vote import whole_scene_vote_predict
    from pointcloud_bridge_tpu_torch.parallel import make_mesh

    out = {"1x2": _ep_run(1, 2), "2x1": _ep_run(2, 1), "split_group": _ep_run(2, 1, 64)}
    xyz, rgb, labels = toy_bridge_scene(3000, seed=0)
    pts6 = np.concatenate([xyz, rgb], axis=1).astype(np.float32)
    grid = dict(num_classes=5, block_points=128, block_size=6.0, stride=3.0, num_votes=2,
                batch_size=3, seed=3)
    lw = scene_labelweights([labels], 5)
    model = ssg(0)
    single = whole_scene_vote_predict(model, pts6, labels, lw, **grid)
    meshed = whole_scene_vote_predict(model, pts6, labels, lw, mesh=make_mesh(world), **grid)
    out["vote"] = {"single": single["pred"], "mesh": meshed["pred"],
                   "pools": (single["vote_pool"], meshed["vote_pool"])}
    return out


@job
def dryrun(rank, world, path):
    """tools/dryrun_multichip.py's stages over the world, on the CPU."""
    from pointcloud_bridge_tpu_torch.tools.dryrun_multichip import dryrun_multichip

    sys.modules["torch.utils.tensorboard"] = None  # the engine stage's scalar writer
    return dryrun_multichip("cpu")


if __name__ == "__main__":
    sys.path[:0] = [REPO, HERE]
    _main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
