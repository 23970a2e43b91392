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
4. the SSG forward at B=4 x 4096 on the card against the same model on the
   CPU (plain versions), logits within 2e-4; every kernel must have been
   launched; forward time and points/s;
5. serve 48 blocks of two synthetic bridge scenes written as LAS through
   BlockDataset.from_files and run_block_inference, once to warm up and
   once with the launch counters reset just before and read just after;
   wall time and points/s.

The line before the last is the per-kernel JSON summary; the last line is
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

from pointcloud_bridge_tpu_torch.data import (
    BlockDataset,
    toy_bridge_scene,
    write_las,
)
from pointcloud_bridge_tpu_torch.infer import run_block_inference
from pointcloud_bridge_tpu_torch.models import get_model
from pointcloud_bridge_tpu_torch.ops import (
    _kernels,
    grouping,
    interpolate,
    sampling,
)

ROOT = Path(__file__).resolve().parent
SEED = 0
B = 4
N = 4096
NUM_CLASSES = 5
REPS = 20
LOGIT_TOL = 2e-4  # PARITY.md §7's band for torch-vs-JAX logits
INTERP_TOL = 1e-5


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

    def check(self, name, label, kernel_fn, plain_fn, exact, on_path):
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
                  lambda: interpolate.interpolate_cuda(dst, src, f, 3),
                  lambda: interpolate.interpolate_plain(dst, src, f, 3), False, True)
    return res


def randomize_bn(model: torch.nn.Module, gen: torch.Generator) -> None:
    """BatchNorm affine and statistics away from the identity."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
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


def counts_all_launched(where: str) -> dict:
    counts = _kernels.launch_counts()
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"{where}: kernels never launched: {missing} ({counts})")
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

    # 3. kernels against their plain versions
    res = compare_kernels(dev)

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
        with torch.no_grad():
            t0 = time.perf_counter()
            ref = cpu_model(xyz_cpu, rgb_cpu)
            cpu_s = time.perf_counter() - t0
            _kernels.reset_launch_counts()
            out = model(xyz, rgb)
            torch.cuda.synchronize()
            fwd_counts = counts_all_launched("forward")
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
        serve_counts = counts_all_launched("serve")
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
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)

    summary = {
        "kernels": [
            {
                "name": k.name,
                "route": "cuda",
                "source": k.source,
                "replaces": k.replaces,
                "launches": serve_counts[k.name],
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
