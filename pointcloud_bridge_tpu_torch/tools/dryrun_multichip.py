"""Every parallel mode of the port once, over the ranks of one process
group (counterpart of ``__graft_entry__.py::dryrun_multichip``, the JAX
package's 15 stages at its tiny shapes).

Liveness stages first (dp, tp, sp, pp, dp x pp, dp x sp, SSG, BriStruNet,
windowed PTv3 and ptv3_pooled sequence parallelism, ep, fsdp), then the
engine (``train()`` in tp for one epoch) and the two certificates (a dp
step against the single-process step, K = 2 dp steps a dispatch against two
single dp steps). Each stage's loss is held to the single-process loss of
the same weights and batch, which every rank computes itself: the global
batch's loss, or for dp the mean of the ranks' losses as the JAX dp step
defines it (rtol 1e-4). tp needs 4 ranks or more and is skipped below, as
the JAX dryrun skips it. A line a stage with its wall; past the deadline
(``PCB_DRYRUN_DEADLINE_S``, 1500 s) the remaining stages are skipped, and
the run fails if a liveness stage was.

    torchrun --nproc_per_node 4 -m pointcloud_bridge_tpu_torch.tools.dryrun_multichip
    torchrun --nproc_per_node 4 -m pointcloud_bridge_tpu_torch.tools.dryrun_multichip \\
        --device cpu
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

TOL = 1e-4  # the stages' losses against the single-process loss, relative


def _batch(rng, b: int, n: int) -> dict:
    return {"points": rng.uniform(size=(b, n, 3)).astype(np.float32),
            "colors": rng.uniform(size=(b, n, 3)).astype(np.float32),
            "labels": rng.integers(0, 5, (b, n)).astype(np.int32),
            "mask": np.ones(b, bool)}


def _model(name: str, seed: int, device, **kw) -> torch.nn.Module:
    """Registry model ``name`` from a seed, its Dropouts off (a rank draws
    its own masks), on ``device``."""
    from ..models import Dropout, get_model

    model = get_model(name, 5, generator=torch.Generator().manual_seed(seed), **kw)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return model.to(device).train()


def _single_loss(name: str, seed: int, device, batch: dict, shards: int = 0, **kw) -> float:
    """The single-process train-mode weighted loss of the batch; with
    ``shards`` the mean of the losses of that many equal row shards of the
    batch's logits (the JAX dp step's loss)."""
    from .. import losses as L
    from ..train.loop import batch_to_device

    t = batch_to_device(batch, device)
    cw = torch.ones(5, device=device)
    with torch.no_grad():
        logits = _model(name, seed, device, **kw)(t["points"], t["colors"])
    if not shards:
        return L.weighted_cross_entropy(logits, t["labels"], cw).item()
    return float(np.mean([L.weighted_cross_entropy(lg, lb, cw).item() for lg, lb in zip(
        logits.chunk(shards), t["labels"].chunk(shards))]))


def _held(label: str, loss: float, want: float) -> str:
    if not np.isfinite(loss) or abs(loss - want) > TOL * abs(want):
        raise AssertionError(f"{label}: loss {loss} against the single-process {want}")
    return f"{label} ok, loss={loss:.6f} (single-process {want:.6f})"


def dryrun_multichip(device: str = "cuda", deadline: Optional[float] = None) -> Dict[str, dict]:
    """Run the stages over the initialised default process group; every
    rank calls it. Returns {stage: {"wall": seconds or None, "msg": ...}}."""
    from ..config import Config
    from ..parallel import (
        make_2d_mesh, make_dp_multi_train_step, make_dp_train_step, make_ep_mesh,
        make_ep_train_step, make_fsdp_mesh, make_fsdp_train_step, make_mesh, make_named_mesh,
        make_pp_train_step, make_sp_train_step, make_tp_train_step, shard_batch, shard_sp_batch)
    from ..train.loop import batch_to_device

    world, rank = dist.get_world_size(), dist.get_rank()
    dev = torch.device(device if device == "cpu" else f"cuda:{torch.cuda.current_device()}")
    if deadline is None:
        deadline = float(os.environ.get("PCB_DRYRUN_DEADLINE_S", "1500"))
    rng = np.random.default_rng(0)
    b, n = 2 * world, 128
    batch = _batch(rng, b, n)
    loss_cfg = Config().loss
    cw = torch.ones(5, device=dev)
    sgd = lambda m: torch.optim.SGD(m.parameters(), lr=1e-3)  # noqa: E731
    tiny_ssg = dict(sa_npoints=(32, 16, 8))
    ptv3_kw = dict(embed_dim=64, depth=2, num_heads=2)
    sp_batch = _batch(rng, 2, 32 * world)
    pp_batch = _batch(rng, 4, 64)
    half = world // 2

    def mode_dp():
        mesh = make_mesh(world)
        model = _model("pointnet2_ssg", 1, dev, axis_name="data", **tiny_ssg)
        m = make_dp_train_step(model, loss_cfg, sgd(model), mesh)(
            shard_batch(batch, mesh, device=dev), 1e-3, cw)
        return _held("dp", m["loss"].item(),
                     _single_loss("pointnet2_ssg", 1, dev, batch, world, **tiny_ssg))

    def mode_tp():
        mesh = make_2d_mesh(half, 2)
        model = _model("pointnet2_ssg", 2, dev, axis_name="data", **tiny_ssg)
        step, place = make_tp_train_step(model, loss_cfg, sgd(model), mesh)
        m = step(place(batch), 1e-3, cw)
        return _held(f"tp mesh ({half}x2)", m["loss"].item(),
                     _single_loss("pointnet2_ssg", 2, dev, batch, **tiny_ssg))

    def sp_stage(label, name, seed, feed, shard, mesh=None, dp_axis=None, **kw):
        mesh = mesh or make_mesh(world, "sp")
        axis_name = (dp_axis, "sp") if dp_axis else "sp"
        model = _model(name, seed, dev, sp_axis="sp", axis_name=axis_name, **kw)
        step = make_sp_train_step(model, loss_cfg, sgd(model), "sp", dp_axis)
        m = step(shard_sp_batch(feed, mesh, "sp", dp_axis, shard, device=dev), 1e-3, cw)
        return _held(label, m["loss"].item(), _single_loss(name, seed, dev, feed, **kw))

    def pp_stage(label, seed, mesh, dp_axis=None):
        depth = 2 * mesh.size(mesh.mesh_dim_names.index("pp"))
        kw = dict(embed_dim=64, depth=depth, num_heads=2)
        model = _model("ptv3", seed, dev, **({"axis_name": dp_axis} if dp_axis else {}), **kw)
        step, _ = make_pp_train_step(model, loss_cfg, sgd(model), mesh, "pp", 2, dp_axis)
        local = (shard_batch(pp_batch, mesh, dp_axis, device=dev) if dp_axis
                 else batch_to_device(pp_batch, dev))
        m = step(local, 1e-3, cw)
        return _held(label, m["loss"].item(), _single_loss("ptv3", seed, dev, pp_batch, **kw))

    def mode_ep():
        n_exp = max(2, half)
        mesh = make_ep_mesh(2, half)
        kw = dict(embed_dim=64, depth=2, num_heads=2, num_experts=n_exp)
        feed = _batch(np.random.default_rng(1), 4, 256)  # whole token groups a rank
        model = _model("ptv3_moe", 9, dev, axis_name="data", **kw)
        step, place = make_ep_train_step(model, loss_cfg, sgd(model), mesh)
        m = step(place(feed), 1e-3, cw)
        if not np.isfinite(m["aux_loss"].item()):
            raise AssertionError(f"ep: aux loss {m['aux_loss'].item()}")
        return _held(f"ep mesh (2 x {half}, {n_exp} experts)", m["loss"].item(),
                     _single_loss("ptv3_moe", 9, dev, feed, **kw))

    def mode_fsdp():
        mesh = make_fsdp_mesh(world)
        model = _model("pointnet2_ssg", 10, dev, axis_name="data", **tiny_ssg)
        step, place = make_fsdp_train_step(model, loss_cfg, sgd(model), mesh)
        m = step(place(batch), 1e-3, cw)
        return _held("fsdp mesh", m["loss"].item(),
                     _single_loss("pointnet2_ssg", 10, dev, batch, **tiny_ssg))

    def mode_engine_tp():
        from ..config import Config as C
        from ..data import BlockDataset, make_training_blocks
        from ..data.synthetic import toy_bridge_scene
        from ..train import train

        xyz, rgb, labels = toy_bridge_scene(4000, seed=0)
        blocks = make_training_blocks(xyz, rgb, labels, num_points=64, block_size=6.0,
                                      sample_rate=0.2)
        ds = BlockDataset.from_blocks(blocks, ["toy"])
        cfg = C.from_dict({"num_classes": 5, "batch_size": 2 * half, "num_epochs": 1})
        cfg.model.extra = {"sa_npoints": (16, 8, 4)}
        cfg.parallel.num_devices, cfg.parallel.mode, cfg.parallel.tp_axis_size = -1, "tp", 2
        cfg.device = device
        with tempfile.TemporaryDirectory() as td:
            exp = os.path.join(td, "exp")
            dist.barrier()
            out = train(cfg, ds, ds, exp_dir=exp)
        loss = float(out["history"][-1]["train_loss"])
        if not np.isfinite(loss):
            raise AssertionError(f"engine tp: loss {loss}")
        return f"engine(mode=tp) 1-epoch train() ok, loss={loss:.4f}"

    eq_kw = dict(sa_npoints=(32, 16, 8))

    def cert_dp_equality():
        from .. import losses as L

        mesh = make_mesh(world)
        dp_model = _model("pointnet2_ssg", 20, dev, axis_name="data", **eq_kw)
        one = _model("pointnet2_ssg", 20, dev, **eq_kw)
        p0 = [p.detach().clone() for p in one.parameters()]
        m = make_dp_train_step(dp_model, loss_cfg, sgd(dp_model), mesh)(
            shard_batch(batch, mesh, device=dev), 1e-3, cw)
        t = batch_to_device(batch, dev)
        opt = sgd(one)
        loss1 = L.weighted_cross_entropy(one(t["points"], t["colors"]), t["labels"], cw)
        loss1.backward()
        opt.step()
        d1 = torch.cat([(p.detach() - q).ravel() for p, q in zip(one.parameters(), p0)])
        d8 = torch.cat([(p.detach() - q).ravel() for p, q in zip(dp_model.parameters(), p0)])
        cos = (d1 @ d8 / (d1.norm() * d8.norm() + 1e-12)).item()
        if abs(m["loss"].item() - loss1.item()) > 2e-4 * abs(loss1.item()) or cos < 0.99:
            raise AssertionError(f"dp: loss {m['loss'].item()} vs {loss1.item()}, cos {cos}")
        return (f"dp EQUALITY vs single-process ok (loss {m['loss'].item():.6f} == "
                f"{loss1.item():.6f}, update cos={cos:.6f}, SGD)")

    def cert_dp_multistep():
        mesh = make_mesh(world)
        batch2 = _batch(np.random.default_rng(2), b, n)
        seq = _model("pointnet2_ssg", 21, dev, axis_name="data", **eq_kw)
        step = make_dp_train_step(seq, loss_cfg, sgd(seq), mesh)
        losses = [step(shard_batch(bt, mesh, device=dev), 1e-3, cw)["loss"].item()
                  for bt in (batch, batch2)]
        multi = _model("pointnet2_ssg", 21, dev, axis_name="data", **eq_kw)
        stacked = {k: np.stack([batch[k], batch2[k]]) for k in batch}
        mm = make_dp_multi_train_step(multi, loss_cfg, sgd(multi), mesh, 2)
        local = shard_batch(stacked, mesh, dim=1, device=dev)
        if dev.type == "cpu":
            got = mm(local, 1e-3, cw)["loss"].tolist()
        else:  # the K bodies of a dispatch, eagerly: a graph needs a capturable optimizer
            got = mm.run([{k: v[i] for k, v in local.items()} for i in range(2)], cw)
            got = got["loss"].tolist()
        np.testing.assert_allclose(got, losses, rtol=1e-5, atol=1e-6)
        for p, q in zip(seq.parameters(), multi.parameters()):
            np.testing.assert_allclose(q.detach().cpu().numpy(), p.detach().cpu().numpy(),
                                       rtol=1e-5, atol=1e-6)
        return (f"dp MULTI-STEP ok (K=2 steps in one dispatch == 2 sequential dp steps; "
                f"losses {losses[0]:.6f}/{losses[1]:.6f}, params equal)")

    pooled_kw = dict(dims=(32, 32, 32), enc_depths=(1, 1, 1), dec_depths=(1, 1), strides=(4, 4),
                     window_size=8)
    nsp = (4 * world, 2 * world, world)
    stages: Dict[str, Callable[[], str]] = {
        "dp": mode_dp,
        **({"tp": mode_tp} if world >= 4 and world % 2 == 0 else {}),
        "sp": lambda: sp_stage("sp mesh (ring attention)", "ptv3", 3, sp_batch, True, **ptv3_kw),
        "pp": lambda: pp_stage(f"pp mesh ({world} stages, GPipe x2 microbatches)", 4,
                               make_mesh(world, "pp")),
        "dp_x_pp": lambda: pp_stage(f"dp x pp mesh (2 x {half})", 5,
                                    make_named_mesh((2, half), ("data", "pp")), "data"),
        "dp_x_sp": lambda: sp_stage(f"dp x sp mesh (2 x {half})", "ptv3", 6, pp_batch, True,
                                    make_named_mesh((2, half), ("data", "sp")), "data",
                                    **ptv3_kw),
        "ssg_sp": lambda: sp_stage("ssg-sp mesh (query-sharded neighbourhood model)",
                                   "pointnet2_ssg", 7, batch, False, sa_npoints=nsp),
        "bristrunet_sp": lambda: sp_stage("bristrunet-sp mesh (query-sharded flagship model)",
                                          "bristrunet", 8, batch, False, sa_npoints=nsp),
        "windowed_ptv3_sp": lambda: sp_stage(
            "windowed-ptv3-sp mesh (window-aligned point slices, no ring)", "ptv3", 11,
            sp_batch, False, window_size=16, **ptv3_kw),
        "ep": mode_ep,
        "fsdp": mode_fsdp,
        "pooled_sp": lambda: sp_stage(
            "pooled-sp mesh (hierarchical U-Net, per-level sharded/full states)",
            "ptv3_pooled", 12, sp_batch, False, **pooled_kw),
        "engine_tp": mode_engine_tp,
        "cert_dp_equality": cert_dp_equality,
        "cert_dp_multistep": cert_dp_multistep,
    }
    liveness = {k for k in stages if k not in ("engine_tp", "pooled_sp")
                and not k.startswith("cert_")}
    t_start = time.time()
    out: Dict[str, dict] = {}
    for name, fn in stages.items():
        if time.time() - t_start > deadline:
            out[name] = {"wall": None, "msg": "SKIP (deadline)"}
        else:
            t0 = time.time()
            msg = fn()
            out[name] = {"wall": time.time() - t0, "msg": msg}
        if rank == 0:
            wall = out[name]["wall"]
            print(f"dryrun_multichip({world}): {out[name]['msg']} "
                  f"[{'-' if wall is None else f'{wall:.1f}s'}]", flush=True)
    skipped = [k for k, v in out.items() if v["wall"] is None]
    if rank == 0:
        print(f"dryrun_multichip({world}): DONE total={time.time() - t_start:.1f}s", flush=True)
    if any(k in liveness for k in skipped):
        raise RuntimeError(f"deadline starved liveness stages: {skipped}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cpu":
        dist.init_process_group("gloo")
    else:
        local = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(local)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dist.init_process_group("nccl", device_id=local)
    try:
        dryrun_multichip(args.device)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
