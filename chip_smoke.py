#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA Hopper card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It drives the port (pointcloud_bridge_tpu_torch), never JAX, in phases;
any failure raises and exits non-zero:

1. require CUDA, print the card (nvidia-smi name and power limit), turn
   TF32 off for matmuls and cuDNN;
2. build the CUDA kernels from csrc/ (timed, with the ptxas report);
3. hold each kernel against its plain PyTorch version on the card at the
   PointNet++ SSG shapes (B=4, 4096 points): FPS, ball query and group
   bit-identical, interpolation within 1e-5; median times of both from
   CUDA events;
3b. the backward kernels against their plain versions at the SSG train
   shapes (B=4): group backward (sa2, sa3) and interpolation backward (fp3,
   fp2, fp1, on the selection the forward kernel saved), within 1e-5 of
   max|plain|; median times of both;
4. the SSG forward at B=4 x 4096 on the card against the same model on the
   CPU (plain versions), logits within 2e-4; every forward kernel must have
   been launched; forward time and points/s;
5. serve 48 blocks of two synthetic bridge scenes written as LAS through
   BlockDataset.from_files and run_block_inference, once to warm up and
   once with the launch counters reset just before and read just after;
   wall time and points/s;
6. one SSG train step (forward, weighted CE, backward) at B=4 x 4096 on the
   card against the same step on the CPU: first with the BatchNorms frozen
   (every gradient leaf within 1e-3 of its max|g|), then in train mode:
   loss within 1e-5 relative, updated BatchNorm statistics within 1e-4 of
   max|stat|, every gradient leaf compared (see check_train_step for the
   bands and why), and all six kernels launched;
7. two epochs of training through the port's CLI (train_cli.main) on the
   two LAS scenes, validating on one of them, with the launch counters
   reset just before and read just after; finite losses, best_model and
   latest_checkpoint written, a reload of latest_checkpoint gives the
   trained model's eval logits exactly; steady-state train step at batch
   16 (ms, points/s) and peak device memory.

The line before the last is the per-kernel JSON summary (launches: serve
for the forward kernels, training for the backward ones); the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from pointcloud_bridge_tpu_torch import losses, train_cli
from pointcloud_bridge_tpu_torch.config import LossConfig
from pointcloud_bridge_tpu_torch.data import (
    BlockDataset,
    toy_bridge_scene,
    write_las,
)
from pointcloud_bridge_tpu_torch.infer import run_block_inference
from pointcloud_bridge_tpu_torch.models import BatchNorm, get_model
from pointcloud_bridge_tpu_torch.ops import (
    _kernels,
    grouping,
    interpolate,
    sampling,
)
from pointcloud_bridge_tpu_torch.train import make_optimizer, make_train_step
from pointcloud_bridge_tpu_torch.utils.checkpoint import restore_checkpoint

ROOT = Path(__file__).resolve().parent
SEED = 0
B = 4
N = 4096
NUM_CLASSES = 5
REPS = 20
LOGIT_TOL = 2e-4  # PARITY.md §7's band for torch-vs-JAX logits
INTERP_TOL = 1e-5
BWD_TOL = 1e-5  # of max|plain|: float atomics add in another order
FORWARD_KERNELS = ("fps", "ball_query", "group", "interpolate")
BACKWARD_KERNELS = ("group_bwd", "interp_bwd")


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median milliseconds of fn() over reps, each bracketed by CUDA events
    (so a short kernel's time includes its host launch)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.double() - b.double()).abs().max().item() if a.numel() else 0.0


class Results:
    """Per-kernel comparison results; 'on path' cases add to the totals."""

    def __init__(self):
        self.err = {k.name: 0.0 for k in _kernels.KERNELS}
        self.ms = {k.name: 0.0 for k in _kernels.KERNELS}
        self.plain_ms = {k.name: 0.0 for k in _kernels.KERNELS}

    def check(self, name, label, kernel_fn, plain_fn, exact, on_path, scaled=False):
        """exact: bit-identical; else within INTERP_TOL (rtol and atol), or
        with scaled=True within BWD_TOL * max|plain|."""
        got = kernel_fn()
        want = plain_fn()
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(
                f"{name} {label}: {tuple(got.shape)} {got.dtype} vs "
                f"{tuple(want.shape)} {want.dtype}"
            )
        err = max_abs_err(got, want)
        if exact:
            ok = torch.equal(got, want)
        elif scaled:
            ok = err <= BWD_TOL * want.abs().max().item()
        else:
            ok = torch.allclose(got, want, rtol=INTERP_TOL, atol=INTERP_TOL)
        if not ok:
            raise AssertionError(f"{name} {label}: kernel disagrees, max |err| {err}")
        self.err[name] = max(self.err[name], err)
        line = f"{name:12s} {label:34s} max|err| {err:.3g}"
        if on_path:
            k_ms = time_ms(kernel_fn)
            p_ms = time_ms(plain_fn)
            self.ms[name] += k_ms
            self.plain_ms[name] += p_ms
            line += f"  kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms"
        print(line, flush=True)


def compare_kernels(dev: torch.device) -> Results:
    """Phase 3: each kernel against its plain version at the SSG shapes."""
    rng = np.random.default_rng(SEED)

    def cloud(n):
        return torch.from_numpy(rng.uniform(size=(B, n, 3)).astype(np.float32)).to(dev)

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    res = Results()
    zero = torch.zeros(B, dtype=torch.int32, device=dev)

    # K1 FPS: the three SA levels, a [B] start, duplicated points (ties)
    for n, npoint in ((4096, 1024), (1024, 256), (256, 64)):
        xyz = cloud(n)
        res.check("fps", f"{n}->{npoint}",
                  lambda: sampling.fps_cuda(xyz, npoint, zero),
                  lambda: sampling.fps_plain(xyz, npoint, zero), True, True)
    xyz = cloud(4096)
    start = torch.from_numpy(rng.integers(0, 4096, B).astype(np.int32)).to(dev)
    res.check("fps", "4096->1024 start [B]",
              lambda: sampling.fps_cuda(xyz, 1024, start),
              lambda: sampling.fps_plain(xyz, 1024, start), True, False)
    grid = torch.from_numpy(rng.integers(0, 8, (B, 4096, 3)).astype(np.float32)).to(dev)
    res.check("fps", "4096->256 duplicated points",
              lambda: sampling.fps_cuda(grid, 256, zero),
              lambda: sampling.fps_plain(grid, 256, zero), True, False)

    # K2 ball query: the three SA levels (centres are cloud points, as after
    # FPS), an empty ball, more slots than points
    balls = {}
    for n, s, k, r in ((4096, 1024, 32, 0.1), (1024, 256, 32, 0.2), (256, 64, 32, 0.4)):
        xyz = cloud(n)
        centers = xyz[:, :s].contiguous()
        balls[n] = (xyz, centers)
        res.check("ball_query", f"N={n} S={s} K={k} r={r}",
                  lambda: grouping.ball_query_cuda(r, k, xyz, centers),
                  lambda: grouping.ball_query_plain(r, k, xyz, centers), True, True)
    xyz = cloud(4096)
    far = torch.full((B, 64, 3), 10.0, device=dev)
    res.check("ball_query", "empty balls",
              lambda: grouping.ball_query_cuda(0.1, 32, xyz, far),
              lambda: grouping.ball_query_plain(0.1, 32, xyz, far), True, False)
    xyz = cloud(16)
    centers = xyz[:, :8].contiguous()
    res.check("ball_query", "K=32 > N=16",
              lambda: grouping.ball_query_cuda(0.5, 32, xyz, centers),
              lambda: grouping.ball_query_plain(0.5, 32, xyz, centers), True, False)

    # K3 group: C=0 and the three SA levels' (N, S, C), idx from ball query
    for n, s, c, r, on_path in ((4096, 1024, 0, 0.1, False), (4096, 1024, 3, 0.1, True),
                                (1024, 256, 128, 0.2, True), (256, 64, 256, 0.4, True)):
        xyz, centers = balls[n]
        idx = grouping.ball_query_cuda(r, 32, xyz, centers)
        feats = normal(B, n, c) if c else None
        res.check("group", f"N={n} S={s} K=32 C={c}",
                  lambda: grouping.group_cuda(xyz, centers, idx, feats),
                  lambda: grouping.group_plain(xyz, centers, idx, feats), True, on_path)

    # K4 interpolation: the three FP levels; the sources are a subset of the
    # destinations, as FPS makes them (zero distances included)
    for n, s, d in ((256, 64, 512), (1024, 256, 256), (4096, 1024, 128)):
        dst = cloud(n)
        src = dst[:, :s].contiguous()
        f = normal(B, s, d)
        res.check("interpolate", f"N={n} S={s} D={d} k=3",
                  lambda: interpolate.interpolate_cuda(dst, src, f, 3)[0],
                  lambda: interpolate.interpolate_plain(dst, src, f, 3)[0], False, True)
    return res


def compare_backward_kernels(dev: torch.device, res: Results) -> None:
    """Phase 3b: the backward kernels against their plain versions at the
    SSG train shapes (B=4)."""
    rng = np.random.default_rng(SEED + 1)

    def cloud(n):
        return torch.from_numpy(rng.uniform(size=(B, n, 3)).astype(np.float32)).to(dev)

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    # K3b: the feature channels of g [B,S,K,3+C] -> [B,N,C] over ball-query
    # indices (repeats and all), as at sa2 and sa3; then an empty-ball case
    # with the xyz channels too
    for n, s, c, r in ((1024, 256, 128, 0.2), (256, 64, 256, 0.4)):
        xyz = cloud(n)
        idx = grouping.ball_query_cuda(r, 32, xyz, xyz[:, :s].contiguous())
        g = normal(B, s, 32, 3 + c)
        res.check("group_bwd", f"g [{B},{s},32,{3 + c}] -> [{B},{n},{c}]",
                  lambda: grouping.group_backward_cuda(g, idx, n, 3, 3 + c),
                  lambda: grouping.group_backward_plain(g, idx, n, 3, 3 + c),
                  False, True, scaled=True)
    xyz = cloud(1024)
    far = torch.full((B, 64, 3), 10.0, device=dev)
    idx = grouping.ball_query_cuda(0.1, 32, xyz, far)  # every slot N
    g = normal(B, 64, 32, 3 + 16)
    res.check("group_bwd", "empty balls, xyz and features",
              lambda: grouping.group_backward_cuda(g, idx, 1024, 0, 19),
              lambda: grouping.group_backward_plain(g, idx, 1024, 0, 19),
              False, False, scaled=True)

    # K4b on the selection the forward kernel keeps; the kept selection
    # itself is held to the plain one (indices exact, weights 1e-6)
    for n, s, d in ((256, 64, 512), (1024, 256, 256), (4096, 1024, 128)):
        dst = cloud(n)
        src = dst[:, :s].contiguous()
        f = normal(B, s, d)
        _, idx, w = interpolate.interpolate_cuda(dst, src, f, 3, True)
        _, pidx, pw = interpolate.interpolate_plain(dst, src, f, 3, True)
        if not torch.equal(idx, pidx) or not torch.allclose(w, pw, rtol=1e-6, atol=1e-7):
            raise AssertionError(f"interpolate N={n} S={s}: kept selection differs from plain")
        g = normal(B, n, d)
        res.check("interp_bwd", f"g [{B},{n},{d}] -> [{B},{s},{d}] k=3",
                  lambda: interpolate.interpolate_backward_cuda(g, idx, w, s),
                  lambda: interpolate.interpolate_backward_plain(g, idx, w, s),
                  False, True, scaled=True)


def randomize_bn(model: torch.nn.Module, gen: torch.Generator) -> None:
    """BatchNorm affine and statistics away from the identity."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                c = m.num_features
                m.weight.copy_(0.5 + torch.rand(c, generator=gen))
                m.bias.copy_(0.1 * torch.randn(c, generator=gen))
                m.running_mean.copy_(0.1 * torch.randn(c, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(c, generator=gen))


def make_dataset(data_dir: Path) -> BlockDataset:
    """Two synthetic 200k-point bridge scenes as LAS -> 4096-point blocks."""
    data_dir.mkdir(parents=True, exist_ok=True)
    files = []
    for s in (0, 1):
        xyz, rgb, labels = toy_bridge_scene(200_000, seed=s)
        path = data_dir / f"bridge_{s}.las"
        write_las(str(path), xyz, rgb, labels)
        files.append(str(path))
    return BlockDataset.from_files(files, num_points=N, num_classes=NUM_CLASSES)


def counts_all_launched(where: str, kernels) -> dict:
    counts = _kernels.launch_counts()
    missing = [k for k in kernels if counts[k] == 0]
    if missing:
        raise AssertionError(f"{where}: kernels never launched: {missing} ({counts})")
    return counts


def is_pre_bn_bias(name: str) -> bool:
    """A conv bias that feeds a train-mode BatchNorm: the batch mean takes
    it out again, so its gradient is exactly 0 and any float32 value of it
    is rounding noise."""
    return name.endswith(".bias") and (".mlp_convs." in name or name == "conv1.bias")


def loss_and_grads(model, xyz, rgb, labels, cw):
    """One forward (in the model's mode) and backward on model's device ->
    (loss, {name: grad}); the gradients are cleared on the model."""
    dev = next(model.parameters()).device
    logits = model(xyz.to(dev), rgb.to(dev))
    loss = losses.weighted_cross_entropy(logits, labels.to(dev), cw.to(dev))
    loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.detach(), grads


def check_frozen_bn_gradients(model, cpu_model, xyz, rgb, labels, cw) -> None:
    """Phase 6a: the gradient of the same loss with the BatchNorms frozen
    (eval mode), on the card and on the CPU. Without the batch statistics
    the step is well conditioned, so every leaf is held element by element
    within 1e-3 * max|g_leaf| + 1e-7 and the loss within 1e-5 relative:
    a gradient lost or misplaced by a backward kernel shows here."""
    model.eval()
    cpu_model.eval()
    cpu_loss, cpu_grads = loss_and_grads(cpu_model, xyz, rgb, labels, cw)
    loss, grads = loss_and_grads(model, xyz, rgb, labels, cw)
    torch.cuda.synchronize()
    loss_rel = abs(loss.item() - cpu_loss.item()) / abs(cpu_loss.item())
    worst, rel_l2, faults = (0.0, ""), (0.0, ""), []
    for name, want in cpu_grads.items():
        got = grads[name]
        if got is None or not torch.isfinite(got).all():
            faults.append(f"{name}: gradient {got if got is None else 'not finite'}")
            continue
        got, want = got.double().cpu(), want.double()
        err = (got - want).abs().max().item()
        size = want.abs().max().item()
        if err > 1e-3 * size + 1e-7 or (size > 0 and got.abs().max().item() == 0):
            faults.append(f"{name}: max|err| {err:.3g}, max|g| {size:.3g}")
        worst = max(worst, (err / (1e-3 * size + 1e-7), name))
        rel_l2 = max(rel_l2, ((got - want).norm().item() / max(want.norm().item(), 1e-30), name))
    print(f"frozen-BN gradients: loss {loss.item():.7f} (CPU {cpu_loss.item():.7f}, rel "
          f"{loss_rel:.3g}); over {len(cpu_grads)} leaves the worst max|err| is at "
          f"{worst[0]:.3g} of its band ({worst[1]}), the worst relative L2 "
          f"{rel_l2[0]:.3g} ({rel_l2[1]})", flush=True)
    if loss_rel > 1e-5 or faults:
        raise AssertionError(f"frozen-BN gradients: loss rel {loss_rel:.3g}; " + "; ".join(faults))


def check_train_step(model, cpu_model, xyz, rgb, labels, cw) -> dict:
    """Phase 6: one train-mode forward and backward on the card (kernels)
    and on the CPU (plain versions) from the same weights and batch.

    Bands. The loss within 1e-5 relative, the updated BatchNorm statistics
    within 1e-4 * max|stat| + 1e-7. Gradients cannot be held element by
    element: at initialisation the 17 train-mode BatchNorms in sequence
    amplify float32 rounding so far that two CPU runs of this very step
    with 4 and 3 threads (another GEMM blocking) differ by up to 10% of
    max|g| on a leaf, by up to 6% in relative L2, with cosine down to
    0.9985; the JAX package's own float32 step is 1-8% of max|g| from its
    float64 step (tests/test_torch_train.py). So each leaf is held in
    aggregate, at about three times that spread: relative L2 <= 0.2 and
    cosine >= 0.98; a leaf that is nonzero on the CPU must be nonzero on
    the card (a lost gradient gives relative L2 1 and cosine 0). The conv
    biases that feed a BatchNorm have an exactly zero gradient: both sides
    must keep it below 1e-3 * max|g| of the same conv's weight. Phase 6a
    and the kernels' own phases 3 and 3b hold element by element.
    """
    cpu_model.train()
    t0 = time.perf_counter()
    cpu_loss, cpu_grads = loss_and_grads(cpu_model, xyz, rgb, labels, cw)
    cpu_s = time.perf_counter() - t0
    model.train()
    _kernels.reset_launch_counts()
    loss, grads = loss_and_grads(model, xyz, rgb, labels, cw)
    torch.cuda.synchronize()
    counts = counts_all_launched("train step", FORWARD_KERNELS + BACKWARD_KERNELS)
    if not torch.isfinite(loss):
        raise AssertionError(f"train step: loss {loss.item()}")
    loss_rel = abs(loss.item() - cpu_loss.item()) / abs(cpu_loss.item())
    if loss_rel > 1e-5:
        raise AssertionError(f"train step: loss {loss.item()} vs CPU {cpu_loss.item()}")

    # every leaf is measured and printed first, then held to its band
    rows, biases, faults = [], [], []
    for name, got in grads.items():
        want = cpu_grads[name].double()
        if got is None:
            faults.append(f"no gradient for {name} on the card")
            continue
        got = got.double().cpu()
        if not torch.isfinite(got).all():
            faults.append(f"non-finite gradient for {name}")
            continue
        if is_pre_bn_bias(name):
            bound = 1e-3 * cpu_grads[name[:-4] + "weight"].abs().max().item()
            size = max(got.abs().max().item(), want.abs().max().item())
            biases.append((size / bound, name))
            continue
        if want.abs().max() > 0 and got.abs().max() == 0:
            faults.append(f"zero gradient for {name} on the card")
            continue
        rows.append({
            "name": name,
            "max_err": ((got - want).abs().max() / want.abs().max()).item(),
            "rel_l2": ((got - want).norm() / want.norm()).item(),
            "cos": (got.ravel() @ want.ravel() / (got.norm() * want.norm())).item(),
        })
    rows.sort(key=lambda r: -r["max_err"])
    for r in rows[:6]:
        print(f"  grad {r['name']:28s} max|err|/max|g| {r['max_err']:.3e} "
              f"rel L2 {r['rel_l2']:.3e} cosine {r['cos']:.8f}")
    faults += [f"{r['name']} gradient relative L2 {r['rel_l2']:.3g}, cosine {r['cos']:.6f}"
               for r in rows if r["rel_l2"] > 0.2 or r["cos"] < 0.98]
    faults += [f"{name} gradient {frac:.3g} of its zero bound" for frac, name in biases if frac > 1]

    cpu_bufs = dict(cpu_model.named_buffers())
    stat_err = (0.0, "")
    for name, buf in model.named_buffers():
        if name.endswith("num_batches_tracked"):
            continue
        want = cpu_bufs[name].double()
        err = (buf.double().cpu() - want).abs().max().item() / want.abs().max().item()
        if err > 1e-4:
            faults.append(f"{name} {err:.3g} of max|stat| from the CPU")
        stat_err = max(stat_err, (err, name))
    worst = lambda key, sign=1: max(rows, key=lambda r: sign * r[key])  # noqa: E731
    print(f"train step: B={B} N={N} loss {loss.item():.7f} (CPU {cpu_loss.item():.7f}, "
          f"rel {loss_rel:.3g}); gradients over {len(rows)} leaves: worst max|err|/max|g| "
          f"{worst('max_err')['max_err']:.4g}, worst relative L2 {worst('rel_l2')['rel_l2']:.4g} "
          f"({worst('rel_l2')['name']}), worst cosine {worst('cos', -1)['cos']:.6f}; "
          f"zero-gradient biases at {max(biases)[0]:.3g} of their bound; BatchNorm statistics "
          f"worst {stat_err[0]:.3g} of max|stat| ({stat_err[1]}); launches {counts}; "
          f"CPU reference step {cpu_s:.2f} s (host)", flush=True)
    if faults:
        raise AssertionError("train step: " + "; ".join(faults))
    return counts


def train_through_cli(data_dir: Path, dev: torch.device) -> dict:
    """Phase 7: two epochs through train_cli.main on the two LAS scenes,
    validating on the second; launch counts of exactly that run."""
    val_dir = data_dir / "val"
    val_dir.mkdir(exist_ok=True)
    shutil.copy(data_dir / "bridge_1.las", val_dir / "bridge_1.las")
    _kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = train_cli.main([
        "--train-dir", str(data_dir), "--val-dir", str(val_dir),
        "--model", "pointnet2_ssg", "--num-classes", str(NUM_CLASSES),
        "--num-points", str(N), "--batch-size", "16", "--num-epochs", "2",
        "--loss", "weighted_ce", "--scheduler", "cosine", "--case", "chip_smoke",
        "--device", "cuda",
    ])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = counts_all_launched("training", FORWARD_KERNELS + BACKWARD_KERNELS)
    exp_dir = Path(out["exp_dir"])
    try:
        hist = out["history"]
        if [r["epoch"] for r in hist] != [1, 2]:
            raise AssertionError(f"training: epochs {[r['epoch'] for r in hist]}")
        for r in hist:
            for key in ("train_loss", "val_loss", "val_acc", "val_miou"):
                if not np.isfinite(r[key]):
                    raise AssertionError(f"training: epoch {r['epoch']} {key} = {r[key]}")
        for name in ("best_model", "latest_checkpoint"):
            if not (exp_dir / name).is_file():
                raise AssertionError(f"training: {name} not written")
        train_mem = torch.cuda.max_memory_allocated()

        # a reload of latest_checkpoint gives the trained model's logits
        model = out["model"]
        ds = BlockDataset.from_files([str(data_dir / "bridge_0.las")], num_points=N,
                                     num_classes=NUM_CLASSES)
        xyz = torch.from_numpy(np.ascontiguousarray(ds.points[:16], np.float32)).to(dev)
        rgb = torch.from_numpy(np.ascontiguousarray(ds.colors[:16], np.float32)).to(dev)
        labels = torch.from_numpy(ds.labels[:16].astype(np.int64)).to(dev)
        reloaded = get_model("pointnet2_ssg", NUM_CLASSES).to(dev)
        reloaded.load_state_dict(
            restore_checkpoint(str(exp_dir / "latest_checkpoint"), map_location=dev)["model"])
        model.eval()
        reloaded.eval()
        with torch.inference_mode():
            same = torch.equal(model(xyz, rgb), reloaded(xyz, rgb))
        if not same:
            raise AssertionError("training: the reloaded checkpoint gives other logits")

        # steady-state train step at batch 16 on a copy of the trained model
        opt = make_optimizer(reloaded.parameters())
        step = make_train_step(reloaded, LossConfig(name="weighted_ce"), opt)
        cw = out["class_weights"]
        batch = {"points": xyz, "colors": rgb, "labels": labels}
        torch.cuda.reset_peak_memory_stats()
        step_ms = time_ms(lambda: step(batch, 1e-4, cw), reps=20, warmup=5)
        step_mem = torch.cuda.max_memory_allocated()
    finally:
        shutil.rmtree(exp_dir, ignore_errors=True)
    epoch_s = [round(r["epoch_time_s"], 4) for r in hist]
    print(f"training: 2 epochs through train_cli in {wall:.2f} s wall (epochs {epoch_s} s), "
          f"train loss {[round(r['train_loss'], 4) for r in hist]}, val OA "
          f"{[round(r['val_acc'], 4) for r in hist]}, launches {counts}, peak device memory "
          f"{train_mem / 2**20:.1f} MiB; reloaded latest_checkpoint: eval logits identical",
          flush=True)
    print(f"train step: batch 16 x {N} {step_ms:.3f} ms, {16 * N / step_ms * 1e3:.0f} "
          f"points/s trained, peak device memory {step_mem / 2**20:.1f} MiB", flush=True)
    return counts


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"capability {torch.cuda.get_device_capability(0)}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    so = _kernels.build()
    _kernels.library()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {so.relative_to(ROOT)}")
    for line in so.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas {line.strip()}")

    # 3. kernels against their plain versions; 3b. the backward kernels
    res = compare_kernels(dev)
    compare_backward_kernels(dev, res)

    # 4. the SSG forward on the card against the CPU
    data_dir = ROOT / "build" / "chip_smoke_data"
    try:
        t0 = time.perf_counter()
        ds = make_dataset(data_dir)
        print(f"dataset: {len(ds)} blocks x {ds.num_points} points from 2 LAS scenes "
              f"in {time.perf_counter() - t0:.2f} s (host)")
        gen = torch.Generator().manual_seed(SEED)
        model = get_model("pointnet2_ssg", NUM_CLASSES, generator=gen)
        randomize_bn(model, gen)
        model.eval()
        cpu_model = copy.deepcopy(model)
        model.to(dev)
        xyz_cpu = torch.from_numpy(np.ascontiguousarray(ds.points[:B], np.float32))
        rgb_cpu = torch.from_numpy(np.ascontiguousarray(ds.colors[:B], np.float32))
        xyz, rgb = xyz_cpu.to(dev), rgb_cpu.to(dev)
        with torch.inference_mode():
            t0 = time.perf_counter()
            ref = cpu_model(xyz_cpu, rgb_cpu)
            cpu_s = time.perf_counter() - t0
            _kernels.reset_launch_counts()
            out = model(xyz, rgb)
            torch.cuda.synchronize()
            fwd_counts = counts_all_launched("forward", FORWARD_KERNELS)
            out = out.cpu()
            err = max_abs_err(out, ref)
            agree = (out.argmax(-1) == ref.argmax(-1)).double().mean().item()
            print(f"forward: logits {tuple(out.shape)} CUDA vs CPU max|err| {err:.3g}, "
                  f"argmax agreement {agree:.6f}, launches {fwd_counts}, "
                  f"CPU reference forward {cpu_s:.2f} s (host)")
            if not torch.isfinite(out).all():
                raise AssertionError("forward: non-finite logits")
            if not torch.allclose(out, ref, rtol=LOGIT_TOL, atol=LOGIT_TOL):
                raise AssertionError(f"forward: CUDA logits differ from CPU by {err}")
            fwd_ms = time_ms(lambda: model(xyz, rgb))
        print(f"forward: B={B} N={N} {fwd_ms:.3f} ms, {B * N / fwd_ms * 1e3:.0f} points/s")

        # 5. serve the 48 blocks twice: the first call meets the batch-16
        # shapes for the first time (library kernels load lazily); the
        # counters cover exactly the second
        t0 = time.perf_counter()
        run_block_inference(model, ds, NUM_CLASSES, batch_size=16, device=dev)
        first_wall = time.perf_counter() - t0
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        served = run_block_inference(model, ds, NUM_CLASSES, batch_size=16, device=dev)
        wall = time.perf_counter() - t0
        serve_counts = counts_all_launched("serve", FORWARD_KERNELS)
        if any(serve_counts[k] for k in BACKWARD_KERNELS):
            raise AssertionError(f"serve: a backward kernel ran ({serve_counts})")
        preds = served["predictions"]
        if preds.shape != (len(ds), N) or len(ds) != 48:
            raise AssertionError(f"serve: predictions {preds.shape}, {len(ds)} blocks")
        g = served["global"]
        for key in ("mIoU", "OA", "mAcc", "Precision", "Recall", "F1_score"):
            if not np.isfinite(g[key]):
                raise AssertionError(f"serve: {key} = {g[key]}")
        same = (preds[:B] == ref.argmax(-1).numpy()).mean()
        if same < 0.999:
            raise AssertionError(f"serve: blocks 0-3 agree with the CPU forward on {same}")
        print(f"serve: {len(ds)} blocks in {wall:.4f} s wall, "
              f"{len(ds) * N / wall:.0f} points/s (first call {first_wall:.4f} s), "
              f"launches {serve_counts}, "
              f"OA {g['OA']:.4f} mIoU {g['mIoU']:.4f} (random weights), "
              f"blocks 0-3 vs CPU argmax {same:.6f}")

        # 6. one train step on the card against the CPU (dropout 0, weighted
        # CE with the dataset's class weights)
        gen = torch.Generator().manual_seed(SEED + 6)
        model = get_model("pointnet2_ssg", NUM_CLASSES, generator=gen, dropout_rate=0.0)
        randomize_bn(model, gen)
        cpu_model = copy.deepcopy(model)
        model.to(dev)
        labels = torch.from_numpy(ds.labels[:B].astype(np.int64))
        cw = losses.class_weights_from_counts(ds.label_counts(NUM_CLASSES))
        check_frozen_bn_gradients(model, cpu_model, xyz_cpu, rgb_cpu, labels, cw)
        check_train_step(model, cpu_model, xyz_cpu, rgb_cpu, labels, cw)

        # 7. train through the CLI
        train_counts = train_through_cli(data_dir, dev)
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
    launches = {k: serve_counts[k] for k in FORWARD_KERNELS}
    launches.update({k: train_counts[k] for k in BACKWARD_KERNELS})

    summary = {
        "kernels": [
            {
                "name": k.name,
                "route": "cuda",
                "source": k.source,
                "replaces": k.replaces,
                "launches": launches[k.name],
                "max_abs_err": res.err[k.name],
                "ms": res.ms[k.name],
                "plain_ms": res.plain_ms[k.name],
            }
            for k in _kernels.KERNELS
        ]
    }
    print(card)
    print(json.dumps(summary))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))


if __name__ == "__main__":
    main()
    sys.stdout.flush()
