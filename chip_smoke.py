#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA Hopper card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It drives the port (pointcloud_bridge_tpu_torch), never JAX, in phases;
any failure raises and exits non-zero:

1. require CUDA, print the card (nvidia-smi name and power limit), turn
   TF32 off for matmuls and cuDNN;
2. build the CUDA kernels from csrc/ (timed, with the ptxas report);
3. hold each kernel against its plain PyTorch version on the card at every
   shape that the PointNet++ SSG forward and the BriStruNet forward give it
   (B=4, 4096 points; BriStruNet: FPS 4096->1024->512->128, ball query and
   group at K=16 and K=32 over two radii a level with 3, 256 and 512 feature
   channels, interpolation at k=4, the exact k-NN kernel at its three
   shapes): FPS, ball query, group and k-NN bit-identical, interpolation
   within 1e-5; median times of both from CUDA events, summed a path,
   beside the least time the card could take (bytes over 3.35 TB/s or
   operations over 67 TFLOP/s float32, whichever is larger) and, where one
   PyTorch call computes the same function, that call's time;
3b. the backward kernels against their plain versions at the SSG train
   shapes (B=4): group backward (sa2, sa3) and interpolation backward (fp3,
   fp2, fp1, on the selection the forward kernel saved), within 1e-5 of
   max|plain|; median times of both;
3c. the flash-attention kernel against the plain attention at every shape
   that the PTv3 family gives it at B=4 x 4096 (the windows of level 0 folded
   to [16,1024,2,32], the global levels [4,1024,4,32] and [4,256,8,32], the
   flat model's [4,4096,2,192] and [4,4096,6,64]), on the strided slices of a
   packed qkv projection of LayerNorm output, and at ragged lengths; within
   2e-5 * max(1, max|plain|); times beside the bound and beside
   F.scaled_dot_product_attention;
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
   16 (ms, points/s) and peak device memory;
8. the BriStruNet forward at full width, B=4 x 4096, random weights and
   BatchNorm statistics, on the card against the CPU (plain versions):
   logits within 2e-4; exactly 3 FPS, 6 ball-query, 6 group, 3
   interpolation and 3 k-NN launches and no backward kernel; forward time,
   points/s, and device time by kernel family from one torch.profiler run;
9. serve through the inference CLI (infer_cli.main) from checkpoints:
   BriStruNet in ``blocks`` mode (once in a fresh interpreter, the cold
   start; then in this one a first call and a warm one with the launch
   counters reset just before and read just after) and in ``scene``
   mode (2 votes a scene, counters likewise), and PointNet++ SSG in
   ``blocks`` mode from the checkpoint phase 7 trained; wall and points/s,
   the CSVs and the printed metric lines checked; one scene once more
   through whole_scene_vote_predict for the split of its phase timings.

10. the ptv3_pooled forward at the benched configuration (dims 64/128/256,
   encoder depths 2/2/6, decoder depths 1/1, strides 4/4, windows of 1024),
   B=4 x 4096, on the card against the CPU: logits within 2e-4; exactly 12
   flash-attention launches and no other kernel; forward time, points/s and
   device time by kernel family;
11. the flat ptv3 forward at its default width (384 wide, 8 blocks, 2 heads
   of 192, global attention over 4096 points), B=4, against the CPU: logits
   within 2e-4, exactly 8 flash-attention launches; forward time;
12. serve ptv3_pooled (the registry's default model) through infer_cli.main
   from a checkpoint the script writes: ``blocks`` over the 48 blocks and
   ``scene`` with 2 votes, counters reset just before and read just after:
   the flash-attention kernel and no other; CSVs, exported LAS and printed
   lines checked; wall and points/s.

The line before the last is the per-kernel JSON summary. A kernel's row
holds one path's numbers together: ``launches`` of one BriStruNet forward at
B=4 (phase 8; of one SSG train step, phase 6, for the backward kernels; of
one ptv3_pooled forward, phase 10, for the flash-attention kernel) beside
``ms``, ``plain_ms``, ``bound_ms`` and ``library_ms`` summed over exactly
those launches' shapes (phases 3, 3b, 3c); ``paths`` has the same for the
other forwards, and ``launches_by_path`` the counts of the serves and the
training run through the CLIs. The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import importlib.util
import io
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from pointcloud_bridge_tpu_torch import infer_cli, losses, train_cli
from pointcloud_bridge_tpu_torch.config import LossConfig
from pointcloud_bridge_tpu_torch.data import BlockDataset, scene_labelweights, write_las
from pointcloud_bridge_tpu_torch.data.dataset import _load_scene
from pointcloud_bridge_tpu_torch.data.synthetic import toy_bridge_scene
from pointcloud_bridge_tpu_torch.infer import run_block_inference, whole_scene_vote_predict
from pointcloud_bridge_tpu_torch.models import BatchNorm, Dense, get_model
from pointcloud_bridge_tpu_torch.ops import (
    _kernels,
    attention,
    grouping,
    interpolate,
    sampling,
)
from pointcloud_bridge_tpu_torch.train import make_optimizer, make_train_step
from pointcloud_bridge_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

ROOT = Path(__file__).resolve().parent
SEED = 0
B = 4
N = 4096
NUM_CLASSES = 5
REPS = 20
LOGIT_TOL = 2e-4  # PARITY.md §7's band for torch-vs-JAX logits
INTERP_TOL = 1e-5
BWD_TOL = 1e-5  # of max|plain|: float atomics add in another order
ATTN_TOL = 2e-5  # of max(1, max|plain|): the online softmax re-associates the sums
FORWARD_KERNELS = ("fps", "ball_query", "group", "interpolate")
BACKWARD_KERNELS = ("group_bwd", "interp_bwd")
# launches of one BriStruNet forward: an FPS a level, two radii a level, an
# interpolation a decoder level, a k-NN in bri_enc, geometric2 and geometric3
BRISTRUNET_LAUNCHES = {"fps": 3, "ball_query": 6, "group": 6, "interpolate": 3, "knn": 3,
                       "group_bwd": 0, "interp_bwd": 0, "flash_attn": 0}
# the benched ptv3_pooled (configs/train_ptv3_pooled.yaml): an attention a block
POOLED_BENCHED = dict(dims=(64, 128, 256), enc_depths=(2, 2, 6), dec_depths=(1, 1),
                      strides=(4, 4), window_size=1024)
# the card's peaks for the bound: HBM3 bytes/s and float32 FLOP/s outside the
# tensor cores (NVIDIA H100 SXM data sheet, at the full 700 W)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = 67e12


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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


SSG, BRISTRUNET, TRAIN = "ssg_forward", "bristrunet_forward", "ssg_train_step"
PTV3_POOLED, PTV3 = "ptv3_pooled_forward", "ptv3_forward"
SUMS = ("ms", "plain_ms", "bytes_ms", "ops_ms", "bound_ms")


class Results:
    """Per-kernel comparison results. A case at a shape that a path gives
    the kernel is timed and adds to that path's sums, so a path's sums are
    over exactly the launches of one forward (or one train step) at B=4."""

    def __init__(self):
        names = [k.name for k in _kernels.KERNELS]
        self.err = dict.fromkeys(names, 0.0)
        self.sums = {path: {name: dict.fromkeys(SUMS, 0.0) | {"library_ms": None, "cases": 0}
                            for name in names}
                     for path in (SSG, BRISTRUNET, TRAIN, PTV3_POOLED, PTV3)}

    def check(self, name, label, kernel_fn, plain_fn, exact, paths=(), scaled=None,
              work=None, library_fn=None, times=1):
        """exact: bit-identical; else within INTERP_TOL (rtol and atol), or
        with scaled=(tol, floor) within tol * max(floor, max|plain|). The
        functions return a tensor or a tuple of tensors. ``paths`` names the
        paths that give the kernel this shape, ``times`` in one pass; such a
        case is timed and needs ``work`` = (bytes, operations) of the
        function on these inputs: each input read once, each output written
        once, and the arithmetic the function needs on this data. A case
        with ``work`` and no path is timed too. ``library_fn`` is the one
        PyTorch call that computes the same function, timed beside the
        kernel."""
        got = kernel_fn()
        want = plain_fn()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err, ok = 0.0, len(got) == len(want)
        for g, w in zip(got, want):
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError(
                    f"{name} {label}: {tuple(g.shape)} {g.dtype} vs {tuple(w.shape)} {w.dtype}"
                )
            e = max_abs_err(g, w)
            err = max(err, e)
            if exact:
                ok &= torch.equal(g, w)
            elif scaled:
                ok &= e <= scaled[0] * max(scaled[1], w.abs().max().item())
            else:
                ok &= torch.allclose(g, w, rtol=INTERP_TOL, atol=INTERP_TOL)
        if not ok:
            raise AssertionError(f"{name} {label}: kernel disagrees, max |err| {err}")
        self.err[name] = max(self.err[name], err)
        line = f"{name:12s} {label:34s} max|err| {err:.3g}"
        if work:
            bytes_ms = work[0] / PEAK_BYTES_S * 1e3
            ops_ms = work[1] / PEAK_FLOPS * 1e3
            case = {"ms": time_ms(kernel_fn), "plain_ms": time_ms(plain_fn),
                    "bytes_ms": bytes_ms, "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms)}
            line += (f"  kernel {case['ms']:.4f} ms  plain {case['plain_ms']:.4f} ms  bound "
                     f"{case['bound_ms']:.5f} ms ({'bytes' if bytes_ms >= ops_ms else 'operations'})")
            l_ms = None
            if library_fn is not None:
                l_ms = time_ms(library_fn)
                line += f"  library {l_ms:.4f} ms"
            for path in paths:
                total = self.sums[path][name]
                total["cases"] += times
                for key in SUMS:
                    total[key] += times * case[key]
                if l_ms is not None:
                    total["library_ms"] = (total["library_ms"] or 0.0) + times * l_ms
            if paths:
                line += f"  [{times} x " + ", ".join(paths) + "]"
        print(line, flush=True)

    def row(self, name: str, path: str, launches: int) -> dict:
        """The numbers of one kernel on one path, as the summary prints
        them; the path must have given the kernel a case a launch."""
        total = self.sums[path][name]
        if total["cases"] != launches:
            raise AssertionError(f"{name} on {path}: {launches} launches a pass, but "
                                 f"{total['cases']} shapes were held against the plain version")
        return {"launches": launches, "ms": total["ms"], "plain_ms": total["plain_ms"],
                "bound_ms": total["bound_ms"],
                "bound_by": "bytes" if total["bytes_ms"] >= total["ops_ms"] else "operations",
                "library_ms": total["library_ms"]}


def compare_kernels(dev: torch.device) -> Results:
    """Phase 3: each kernel against its plain version at the shapes that
    the SSG forward and the BriStruNet forward give it (B=4)."""
    rng = np.random.default_rng(SEED)

    def cloud(n):
        return torch.from_numpy(rng.uniform(size=(B, n, 3)).astype(np.float32)).to(dev)

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    res = Results()
    zero = torch.zeros(B, dtype=torch.int32, device=dev)

    # K1 FPS: the SA levels of both models (the first is the same shape in
    # both), a [B] start, duplicated points (ties)
    for n, npoint, paths in ((4096, 1024, (SSG, BRISTRUNET)), (1024, 256, (SSG,)),
                             (256, 64, (SSG,)), (1024, 512, (BRISTRUNET,)),
                             (512, 128, (BRISTRUNET,))):
        xyz = cloud(n)
        # a step is a distance (8 flops), a min and a compare of each point
        res.check("fps", f"{n}->{npoint}",
                  lambda: sampling.fps_cuda(xyz, npoint, zero),
                  lambda: sampling.fps_plain(xyz, npoint, zero), True, paths,
                  work=(nbytes(xyz, zero) + B * npoint * 4, 10 * B * npoint * n))
    xyz = cloud(4096)
    start = torch.from_numpy(rng.integers(0, 4096, B).astype(np.int32)).to(dev)
    res.check("fps", "4096->1024 start [B]",
              lambda: sampling.fps_cuda(xyz, 1024, start),
              lambda: sampling.fps_plain(xyz, 1024, start), True)
    grid = torch.from_numpy(rng.integers(0, 8, (B, 4096, 3)).astype(np.float32)).to(dev)
    res.check("fps", "4096->256 duplicated points",
              lambda: sampling.fps_cuda(grid, 256, zero),
              lambda: sampling.fps_plain(grid, 256, zero), True)

    def ball_and_group(paths, n, s, k, r, c):
        """K2 at (N, S, K, r) with cloud points as centres, as after FPS,
        then K3 on its indices with C feature channels."""
        xyz = cloud(n)
        centers = xyz[:, :s].contiguous()
        idx = grouping.ball_query_cuda(r, k, xyz, centers)
        res.check("ball_query", f"N={n} S={s} K={k} r={r}",
                  lambda: grouping.ball_query_cuda(r, k, xyz, centers),
                  lambda: grouping.ball_query_plain(r, k, xyz, centers), True, paths,
                  work=(nbytes(xyz, centers) + B * s * k * 4, 9 * ball_scan_length(idx, n)))
        feats = normal(B, n, c)
        flat = idx.reshape(B, -1, 1).clamp(0, n - 1).long().expand(-1, -1, c).contiguous()
        res.check("group", f"N={n} S={s} K={k} C={c}",
                  lambda: grouping.group_cuda(xyz, centers, idx, feats),
                  lambda: grouping.group_plain(xyz, centers, idx, feats), True, paths,
                  work=(nbytes(xyz, centers, idx, feats) + B * s * k * (3 + c) * 4,
                        3 * B * s * k),
                  # the feature channels only, on a ready int64 index
                  library_fn=lambda: torch.gather(feats, 1, flat))

    # K2 ball query and K3 group: the three SA levels of SSG, then those of
    # BriStruNet at both radii (K=16 at the small one, K=32 at the large)
    for n, s, r, c in ((4096, 1024, 0.1, 3), (1024, 256, 0.2, 128), (256, 64, 0.4, 256)):
        ball_and_group((SSG,), n, s, 32, r, c)
    for n, s, radii, c in ((4096, 1024, (0.1, 0.2), 3), (1024, 512, (0.2, 0.4), 256),
                           (512, 128, (0.4, 0.8), 512)):
        for r, k in zip(radii, (16, 32)):
            ball_and_group((BRISTRUNET,), n, s, k, r, c)
    # an empty ball, more slots than points, a group without features
    xyz = cloud(4096)
    far = torch.full((B, 64, 3), 10.0, device=dev)
    res.check("ball_query", "empty balls",
              lambda: grouping.ball_query_cuda(0.1, 32, xyz, far),
              lambda: grouping.ball_query_plain(0.1, 32, xyz, far), True)
    centers = xyz[:, :1024].contiguous()
    idx = grouping.ball_query_cuda(0.1, 32, xyz, centers)
    res.check("group", "N=4096 S=1024 K=32 C=0",
              lambda: grouping.group_cuda(xyz, centers, idx, None),
              lambda: grouping.group_plain(xyz, centers, idx, None), True)
    xyz = cloud(16)
    centers = xyz[:, :8].contiguous()
    res.check("ball_query", "K=32 > N=16",
              lambda: grouping.ball_query_cuda(0.5, 32, xyz, centers),
              lambda: grouping.ball_query_plain(0.5, 32, xyz, centers), True)

    # K4 interpolation: the three FP levels of SSG (k=3) and of BriStruNet
    # (k=4); the sources are a subset of the destinations, as FPS makes them
    # (zero distances included)
    for paths, k, levels in (
        ((SSG,), 3, ((256, 64, 512), (1024, 256, 256), (4096, 1024, 128))),
        ((BRISTRUNET,), 4, ((512, 128, 1024), (1024, 512, 256), (4096, 1024, 256))),
    ):
        for n, s, d in levels:
            dst = cloud(n)
            src = dst[:, :s].contiguous()
            f = normal(B, s, d)
            res.check("interpolate", f"N={n} S={s} D={d} k={k}",
                      lambda: interpolate.interpolate_cuda(dst, src, f, k)[0],
                      lambda: interpolate.interpolate_plain(dst, src, f, k)[0], False, paths,
                      work=interp_work(dst, src, f, k))

    # K5 exact k-NN: the three BriStruNet shapes (self-query), then a query
    # set of its own with k=64 (two registers a lane) and N no multiple of
    # 32, exact ties on an integer grid, k=1, and the serve's batch 16
    for n, k in ((4096, 32), (512, 16), (128, 16)):
        xyz = cloud(n)
        res.check("knn", f"N=S={n} k={k}",
                  lambda: grouping.knn_cuda(xyz, xyz, k),
                  lambda: grouping.knn_plain(xyz, xyz, k), True, (BRISTRUNET,),
                  work=(nbytes(xyz) + B * n * k * 8, 9 * B * n * n),
                  # two calls, so an orientation and no yardstick of one call
                  library_fn=lambda: (torch.cdist(xyz, xyz) ** 2).topk(k, largest=False))
    xyz, query = cloud(3001), cloud(1000)
    res.check("knn", "N=3001 S=1000 k=64",
              lambda: grouping.knn_cuda(xyz, query, 64),
              lambda: grouping.knn_plain(xyz, query, 64), True)
    res.check("knn", "N=3001 S=1000 k=33",
              lambda: grouping.knn_cuda(xyz, query, 33),
              lambda: grouping.knn_plain(xyz, query, 33), True)
    grid = torch.from_numpy(rng.integers(0, 6, (B, 2048, 3)).astype(np.float32)).to(dev)
    for k in (40, 32, 1):
        res.check("knn", f"integer grid (ties) N=S=2048 k={k}",
                  lambda: grouping.knn_cuda(grid, grid, k),
                  lambda: grouping.knn_plain(grid, grid, k), True)
    xyz = torch.from_numpy(rng.uniform(size=(16, 4096, 3)).astype(np.float32)).to(dev)
    res.check("knn", "B=16 N=S=4096 k=32",
              lambda: grouping.knn_cuda(xyz, xyz, 32),
              lambda: grouping.knn_plain(xyz, xyz, 32), True)
    return res


def ball_scan_length(idx: torch.Tensor, n: int) -> int:
    """Points a ball query must visit on this data, summed over the queries:
    up to its k-th hit where the ball holds k (the last slot is then a hit of
    its own, not a copy of the first), else all n."""
    full = idx[..., -1] != idx[..., 0]
    return int(torch.where(full, idx[..., -1] + 1, n).sum().item())


def interp_work(dst, src, f, k: int) -> tuple:
    """(bytes, operations) of an interpolation: every destination measures
    every source (8 flops and a compare), then blends k rows of D."""
    b, n, _ = dst.shape
    s, d = f.shape[1:]
    return nbytes(dst, src, f) + b * n * d * 4, 9 * b * n * s + 2 * k * b * n * d


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
        # library: one index_add_ over the batch-flattened rows (zeroing
        # included, as in the kernel's time), on a ready index and slice
        rows = g[..., 3:].reshape(-1, c).contiguous()
        offs = torch.arange(B, device=dev).view(B, 1, 1) * n
        flat = (idx.clamp(0, n - 1).long() + offs).reshape(-1)
        acc = torch.empty((B * n, c), device=dev)
        res.check("group_bwd", f"g [{B},{s},32,{3 + c}] -> [{B},{n},{c}]",
                  lambda: grouping.group_backward_cuda(g, idx, n, 3, 3 + c),
                  lambda: grouping.group_backward_plain(g, idx, n, 3, 3 + c),
                  False, (TRAIN,), scaled=(BWD_TOL, 0.0),
                  work=(nbytes(rows, idx) + B * n * c * 4, B * s * 32 * c),
                  library_fn=lambda: acc.zero_().index_add_(0, flat, rows))
    xyz = cloud(1024)
    far = torch.full((B, 64, 3), 10.0, device=dev)
    idx = grouping.ball_query_cuda(0.1, 32, xyz, far)  # every slot N
    g = normal(B, 64, 32, 3 + 16)
    res.check("group_bwd", "empty balls, xyz and features",
              lambda: grouping.group_backward_cuda(g, idx, 1024, 0, 19),
              lambda: grouping.group_backward_plain(g, idx, 1024, 0, 19),
              False, scaled=(BWD_TOL, 0.0))

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
        # library: one index_add_ of rows that are weighted already
        rows = (w.unsqueeze(-1) * g.unsqueeze(2)).reshape(-1, d)
        offs = torch.arange(B, device=dev).view(B, 1, 1) * s
        flat = (idx.long() + offs).reshape(-1)
        acc = torch.empty((B * s, d), device=dev)
        res.check("interp_bwd", f"g [{B},{n},{d}] -> [{B},{s},{d}] k=3",
                  lambda: interpolate.interpolate_backward_cuda(g, idx, w, s),
                  lambda: interpolate.interpolate_backward_plain(g, idx, w, s),
                  False, (TRAIN,), scaled=(BWD_TOL, 0.0),
                  work=(nbytes(g, idx, w) + B * s * d * 4, 2 * 3 * B * n * d),
                  library_fn=lambda: acc.zero_().index_add_(0, flat, rows))


def compare_attention_kernel(dev: torch.device, res: Results) -> None:
    """Phase 3c: the flash-attention kernel against the plain attention at
    the shapes the PTv3 family gives it at B=4 x 4096. q, k and v are the
    strided slices of one packed qkv projection (row stride 3*H*D) of
    LayerNorm output, as PointAttention makes them; ``fold`` is the number
    of windows a cloud, folded into the batch by a reshape of those views."""
    rng = np.random.default_rng(SEED + 2)
    gen = torch.Generator().manual_seed(SEED + 2)

    def packed_qkv(n, h, d, fold=1, b=B):
        c = h * d
        x = torch.from_numpy(rng.normal(size=(b, n, c)).astype(np.float32)).to(dev)
        qkv = Dense(c, 3 * c, generator=gen).to(dev)
        with torch.inference_mode():
            out = qkv(torch.nn.functional.layer_norm(x, (c,)))
        views = out.reshape(b, n, 3, h, d).unbind(2)
        return tuple(t.reshape(b * fold, n // fold, h, d) for t in views)

    def case(label, q, k, v, paths=(), times=1, timed=True):
        b, n, h, d = q.shape
        if n > 1 and q.stride(1) != 3 * h * d:
            raise AssertionError(f"flash_attn {label}: not a packed-qkv view")
        work = (4 * nbytes(q), 4 * b * h * n * n * d) if timed else None
        # the library call takes [B, H, N, D]: the same memory, transposed views
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        res.check("flash_attn", label,
                  lambda: attention.attention_cuda(q, k, v),
                  lambda: attention.attention_plain(q, k, v), False, paths,
                  scaled=(ATTN_TOL, 1.0), work=work, times=times,
                  library_fn=lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt))

    # ptv3_pooled at 4096 points: level 0 in four windows of 1024 (2 heads),
    # level 1 (1024 points, 4 heads) and level 2 (256 points, 8 heads) global;
    # the benched depths run them 3, 3 and 6 times a forward
    case("[16,1024,2,32] level 0 windows", *packed_qkv(4096, 2, 32, fold=4), (PTV3_POOLED,), 3)
    case("[4,1024,4,32] level 1", *packed_qkv(1024, 4, 32), (PTV3_POOLED,), 3)
    case("[4,256,8,32] level 2", *packed_qkv(256, 8, 32), (PTV3_POOLED,), 6)
    # flat ptv3: global attention over 4096 points, its default 2 heads of
    # 192 (8 blocks a forward) and the 6 heads of 64 of the wider config
    case("[4,4096,2,192] flat ptv3", *packed_qkv(4096, 2, 192), (PTV3,), 8)
    case("[4,4096,6,64] flat ptv3, 6 heads", *packed_qkv(4096, 6, 64))
    # ragged lengths (no multiple of the 64-row tile), one row, the serve's
    # batch 16, the other head widths
    case("[4,200,2,32] ragged", *packed_qkv(200, 2, 32), timed=False)
    case("[4,1000,4,32] ragged", *packed_qkv(1000, 4, 32), timed=False)
    case("[4,1,2,32] one row", *packed_qkv(1, 2, 32), timed=False)
    case("[64,1024,2,32] batch 16 windows", *packed_qkv(4096, 2, 32, fold=4, b=16), timed=False)
    for d in (96, 128, 160, 224, 256):
        case(f"[2,333,2,{d}] ragged", *packed_qkv(333, 2, d, b=2), timed=False)
    # a contiguous tensor passes too, and the result is contiguous [B,N,H,D]
    q, k, v = (t.contiguous() for t in packed_qkv(130, 2, 64))
    out = attention.attention(q, k, v)
    want = attention.attention_plain(q, k, v)
    if not out.is_contiguous() or max_abs_err(out, want) > ATTN_TOL * max(1.0, want.abs().max().item()):
        raise AssertionError("flash_attn contiguous [4,130,2,64]: kernel disagrees")
    # a tensor that needs a gradient is refused: the kernel has no backward
    try:
        with torch.enable_grad():
            attention.attention(q.clone().requires_grad_(), k, v)
    except NotImplementedError:
        pass
    else:
        raise AssertionError("flash_attn: a tensor that needs a gradient was not refused")


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


def train_through_cli(data_dir: Path, dev: torch.device) -> tuple:
    """Phase 7: two epochs through train_cli.main on the two LAS scenes,
    validating on the second -> (launch counts of exactly that run, the
    experiment directory, which the caller removes)."""
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
    exp_dir = Path(out["exp_dir"]).resolve()
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
    except BaseException:
        shutil.rmtree(exp_dir, ignore_errors=True)
        raise
    epoch_s = [round(r["epoch_time_s"], 4) for r in hist]
    print(f"training: 2 epochs through train_cli in {wall:.2f} s wall (epochs {epoch_s} s), "
          f"train loss {[round(r['train_loss'], 4) for r in hist]}, val OA "
          f"{[round(r['val_acc'], 4) for r in hist]}, launches {counts}, peak device memory "
          f"{train_mem / 2**20:.1f} MiB; reloaded latest_checkpoint: eval logits identical",
          flush=True)
    print(f"train step: batch 16 x {N} {step_ms:.3f} ms, {16 * N / step_ms * 1e3:.0f} "
          f"points/s trained, peak device memory {step_mem / 2**20:.1f} MiB", flush=True)
    return counts, exp_dir


def kernel_family(name: str) -> str:
    """The row of PERF.md's breakdown that a device kernel's name goes to."""
    for key, family in (
        ("fps_kernel", "K1 FPS"), ("ballq_kernel", "K2 ball query"),
        ("group_kernel", "K3 group"), ("interp_kernel", "K4 interpolate"),
        ("knn_kernel", "K5 k-NN"), ("flash_attn_kernel", "K6 flash attention"),
        ("gemm", "GEMMs"), ("gemv", "GEMMs"), ("cutlass", "GEMMs"),
        ("batch_norm", "BatchNorm"), ("layer_norm", "LayerNorm"), ("Sort", "sort"),
        ("sort", "sort"), ("reduce", "reductions"),
        ("gather", "gather, index, cat"), ("index", "gather, index, cat"),
        ("Cat", "gather, index, cat"), ("Memcpy", "copies, memset"),
        ("Memset", "copies, memset"),
    ):
        if key in name:
            return family
    return "elementwise and other"


def forward_against_cpu(label: str, model: torch.nn.Module, ds: BlockDataset,
                        dev: torch.device, launches: dict, profile: bool = True) -> tuple:
    """``model`` (eval mode, on the CPU) at B=4 x 4096 on the card against
    a copy on the CPU (plain versions): logits within 2e-4, exactly
    ``launches`` of each kernel in one forward; forward time and points/s;
    device time by kernel family from one torch.profiler run -> (the model
    on the card, the forward's milliseconds)."""
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
        counts = _kernels.launch_counts()
        if counts != launches:
            raise AssertionError(f"{label}: launches {counts}, expected {launches}")
        out = out.cpu()
        err = max_abs_err(out, ref)
        agree = (out.argmax(-1) == ref.argmax(-1)).double().mean().item()
        print(f"{label}: logits {tuple(out.shape)} CUDA vs CPU max|err| {err:.3g} "
              f"(max|logit| {ref.abs().max().item():.3g}), argmax agreement {agree:.6f}, "
              f"launches {counts}, CPU reference forward {cpu_s:.2f} s (host)", flush=True)
        if out.shape != (B, N, NUM_CLASSES) or not torch.isfinite(out).all():
            raise AssertionError(f"{label}: logits {tuple(out.shape)} not finite")
        if not torch.allclose(out, ref, rtol=LOGIT_TOL, atol=LOGIT_TOL):
            raise AssertionError(f"{label}: CUDA logits differ from CPU by {err}")
        fwd_ms = time_ms(lambda: model(xyz, rgb))
        print(f"{label}: B={B} N={N} {fwd_ms:.3f} ms, "
              f"{B * N / fwd_ms * 1e3:.0f} points/s", flush=True)
        if not profile:
            return model, fwd_ms

        # device time by kernel family over 10 back-to-back forwards
        reps = 10
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                model(xyz, rgb)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        families: dict = {}
        for ev in prof.key_averages():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                us = getattr(ev, "self_device_time_total", None)
                if us is None:  # the attribute's name in older PyTorch
                    us = ev.self_cuda_time_total
                fam = kernel_family(ev.key)
                families[fam] = families.get(fam, 0.0) + us / 1e3 / reps
        busy = sum(families.values())
        if busy > 0:
            print(f"{label} profile (device ms a forward, {reps} back to back, "
                  f"profiler on): busy {busy:.3f}, wall {wall_ms:.3f}, idle "
                  f"{max(0.0, 1 - busy / wall_ms):.1%}")
            for fam, ms in sorted(families.items(), key=lambda kv: -kv[1]):
                print(f"  {fam:24s} {ms:8.3f} ms  {ms / busy:6.1%}")
        else:
            print(f"{label} profile: the profiler recorded no device time")
    return model, fwd_ms


def seeded_model(name: str, seed: int, **kwargs) -> torch.nn.Module:
    """``name`` on the CPU in eval mode, weights and BatchNorm statistics
    drawn from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    model = get_model(name, NUM_CLASSES, generator=gen, **kwargs)
    randomize_bn(model, gen)
    return model.eval()


def only(**launches) -> dict:
    """Launch counts with every kernel at 0 but the named ones."""
    return dict.fromkeys((k.name for k in _kernels.KERNELS), 0) | launches


def run_cli(label: str, argv: list, pattern: str) -> tuple:
    """infer_cli.main(argv) with its standard output kept -> (wall seconds,
    the lines that match ``pattern``, launch counts of exactly this call)."""
    buf = io.StringIO()
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        infer_cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _kernels.launch_counts()
    lines = [ln for ln in buf.getvalue().splitlines() if re.fullmatch(pattern, ln)]
    if not lines:
        raise AssertionError(f"{label}: no metric line in the CLI's output:\n{buf.getvalue()}")
    return wall, lines, counts


GLOBAL_LINE = r"GLOBAL mIoU=[\d.]+ OA=[\d.]+ mAcc=[\d.]+ F1=[\d.]+"


def serve_blocks(label: str, model_name: str, checkpoint: Path, launched: tuple,
                 data_dir: Path, n_blocks: int, dev: torch.device) -> dict:
    """``infer_cli blocks`` over the scenes of data_dir from ``checkpoint``,
    twice; the second, warm call is timed and counted -> its launch counts,
    which must cover ``launched`` and no backward kernel."""
    out_dir = data_dir / "infer_out" / label.replace(" ", "_")
    argv = ["blocks", "--checkpoint", str(checkpoint), "--model", model_name,
            "--data-dir", str(data_dir), "--out-dir", str(out_dir),
            "--num-classes", str(NUM_CLASSES), "--num-points", str(N),
            "--batch-size", "16", "--device", dev.type]
    first, _, _ = run_cli(label, argv, GLOBAL_LINE)
    wall, lines, counts = run_cli(label, argv, GLOBAL_LINE)
    counts_all_launched(label, launched)
    if any(counts[k] for k in BACKWARD_KERNELS):
        raise AssertionError(f"{label}: a backward kernel ran ({counts})")
    cm = np.loadtxt(out_dir / "confusion_matrix.csv", delimiter=",")
    if cm.shape != (NUM_CLASSES, NUM_CLASSES) or cm.sum() != n_blocks * N:
        raise AssertionError(f"{label}: confusion matrix sums to {cm.sum()}")
    if "bridge_0.las" not in (out_dir / "metrics.csv").read_text():
        raise AssertionError(f"{label}: metrics.csv lacks the per-file rows")
    figures = len(list(out_dir.glob("*.png")))
    if not figures and importlib.util.find_spec("matplotlib"):
        raise AssertionError(f"{label}: matplotlib is installed, but no figure was drawn")
    print(f"{label}: {n_blocks} blocks x {N} in {wall:.3f} s wall warm, first call "
          f"{first:.3f} s (LAS read, blocks, checkpoint, forward, CSVs, {figures} figures), "
          f"{n_blocks * N / wall:.0f} points/s end to end, launches {counts}; {lines[-1]}",
          flush=True)
    return counts


def serve_scene(label: str, model_name: str, checkpoint: Path, launched: tuple,
                per_forward: str, data_dir: Path, dev: torch.device) -> dict:
    """``infer_cli scene``: 2 votes over each of the two scenes, predicted
    LAS exported -> the call's launch counts, which must cover ``launched``
    and no backward kernel. ``per_forward`` names a kernel and its launches a
    forward, "knn:3", from which the number of forward batches follows."""
    out_dir = data_dir / "infer_out" / label.replace(" ", "_")
    wall, lines, counts = run_cli(
        label,
        ["scene", "--checkpoint", str(checkpoint), "--model", model_name,
         "--data-dir", str(data_dir), "--out-dir", str(out_dir),
         "--num-classes", str(NUM_CLASSES), "--num-points", str(N), "--batch-size", "16",
         "--num-votes", "2", "--export-las", "--device", dev.type],
        r"OVERALL mIoU=[\d.]+ OA=[\d.]+")
    counts_all_launched(label, launched)
    kernel, each = per_forward.split(":")
    if any(counts[k] for k in BACKWARD_KERNELS) or counts[kernel] % int(each):
        raise AssertionError(f"{label}: launches {counts}")
    scene_points = 0
    for s in (0, 1):
        pts, _, pred = _load_scene(str(out_dir / f"bridge_{s}_pred.las"))
        src, _, _ = _load_scene(str(data_dir / f"bridge_{s}.las"))
        if len(pts) != len(src) or pred.min() < 0 or pred.max() >= NUM_CLASSES:
            raise AssertionError(f"{label}: bridge_{s}_pred.las has {len(pts)} "
                                 f"points of {len(src)}, labels {pred.min()}..{pred.max()}")
        scene_points += len(pts)
    print(f"{label}: 2 scenes, {scene_points} points, 2 votes in {wall:.3f} s "
          f"wall (LAS read, gridding, {counts[kernel] // int(each)} forward batches of <= 16 "
          f"blocks, LAS export), {scene_points / wall:.0f} scene points/s end to end, "
          f"launches {counts}; {lines[-1]}", flush=True)
    return counts


def serve_through_cli(data_dir: Path, ssg_exp_dir: Path, bristrunet: torch.nn.Module,
                      n_blocks: int, dev: torch.device) -> dict:
    """Phase 9: the inference CLI from checkpoints, on the card."""
    ckpt = data_dir / "bristrunet_checkpoint"
    save_checkpoint(str(ckpt), {"model": bristrunet.state_dict(), "epoch": 0})
    forward = tuple(k for k, v in BRISTRUNET_LAUNCHES.items() if v)
    by_path = {}

    # a cold start: the same serve in a fresh interpreter, through the entry
    # point as a user types it (interpreter and CUDA start-up, library loads)
    t0 = time.perf_counter()
    cold = subprocess.run(
        [sys.executable, "-m", "pointcloud_bridge_tpu_torch.infer_cli", "blocks",
         "--checkpoint", str(ckpt), "--model", "bristrunet", "--data-dir", str(data_dir),
         "--out-dir", str(data_dir / "infer_out" / "cold"), "--num-points", str(N),
         "--device", dev.type],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    cold_s = time.perf_counter() - t0
    if cold.returncode != 0 or not re.search(GLOBAL_LINE, cold.stdout):
        raise AssertionError(f"serve bristrunet blocks in a fresh process: exit "
                             f"{cold.returncode}\n{cold.stdout}\n{cold.stderr}")
    print(f"serve bristrunet blocks, a fresh process (python -m ...infer_cli): "
          f"{cold_s:.2f} s wall", flush=True)

    by_path["bristrunet_serve_blocks"] = serve_blocks(
        "serve bristrunet blocks", "bristrunet", ckpt, forward, data_dir, n_blocks, dev)
    by_path["ssg_serve_blocks_cli"] = serve_blocks(
        "serve pointnet2_ssg blocks", "pointnet2_ssg", ssg_exp_dir, FORWARD_KERNELS,
        data_dir, n_blocks, dev)
    if by_path["ssg_serve_blocks_cli"]["knn"]:
        raise AssertionError("serve pointnet2_ssg blocks: the k-NN kernel ran")
    counts = serve_scene("serve bristrunet scene", "bristrunet", ckpt, forward, "knn:3",
                         data_dir, dev)
    if counts["knn"] != counts["fps"]:
        raise AssertionError(f"serve bristrunet scene: launches {counts}")
    by_path["bristrunet_serve_scene"] = counts

    # the split of one scene's vote inference, from the function's own timers
    pts, cols, labels = _load_scene(str(data_dir / "bridge_0.las"))
    res = whole_scene_vote_predict(
        bristrunet, np.concatenate([pts, cols], axis=1), labels,
        scene_labelweights([labels], NUM_CLASSES), NUM_CLASSES, block_points=N,
        num_votes=2, batch_size=16, collect_timings=True)
    if res["pred"].shape != (len(pts),) or not (res["vote_pool"].sum(1) > 0).all():
        raise AssertionError("vote inference: a point got no vote")
    t = res["timings"]
    print("vote inference, one 200k-point scene, 2 votes, host seconds: table upload "
          f"{t['table_upload_s']:.4f}; a vote: "
          + ", ".join(f"{k[:-2]} {[round(v, 4) for v in t[k]]}"
                      for k in ("grid_s", "h2d_s", "dispatch_s", "fetch_s", "scatter_s"))
          + f"; mIoU {res['metrics']['mIoU']:.4f} (random weights)", flush=True)
    return by_path


def serve_ptv3_pooled_through_cli(data_dir: Path, n_blocks: int, dev: torch.device) -> dict:
    """Phase 12: ptv3_pooled as both CLIs build it (the registry's default
    model: encoder depths 2/2/2, 8 attention calls a forward) from a
    checkpoint written here, in ``blocks`` and in ``scene`` mode: the
    flash-attention kernel runs and no other kernel does."""
    ckpt = data_dir / "ptv3_pooled_checkpoint"
    save_checkpoint(str(ckpt), {"model": seeded_model("ptv3_pooled", SEED + 12).state_dict(),
                                "epoch": 0})
    by_path = {
        "ptv3_pooled_serve_blocks": serve_blocks(
            "serve ptv3_pooled blocks", "ptv3_pooled", ckpt, ("flash_attn",), data_dir,
            n_blocks, dev),
        "ptv3_pooled_serve_scene": serve_scene(
            "serve ptv3_pooled scene", "ptv3_pooled", ckpt, ("flash_attn",), "flash_attn:8",
            data_dir, dev),
    }
    for path, counts in by_path.items():
        if counts != only(flash_attn=counts["flash_attn"]):
            raise AssertionError(f"{path}: another kernel than flash_attn ran ({counts})")
    if by_path["ptv3_pooled_serve_blocks"]["flash_attn"] != 8 * -(-n_blocks // 16):
        raise AssertionError(f"serve ptv3_pooled blocks: launches "
                             f"{by_path['ptv3_pooled_serve_blocks']}")
    return by_path


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

    # 3. kernels against their plain versions; 3b. the backward kernels;
    # 3c. the flash-attention kernel
    res = compare_kernels(dev)
    compare_backward_kernels(dev, res)
    compare_attention_kernel(dev, res)

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
        run_block_inference(model, ds, NUM_CLASSES, batch_size=16)
        first_wall = time.perf_counter() - t0
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        served = run_block_inference(model, ds, NUM_CLASSES, batch_size=16)
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
        step_counts = check_train_step(model, cpu_model, xyz_cpu, rgb_cpu, labels, cw)

        # 7. train through the CLI
        train_counts, exp_dir = train_through_cli(data_dir, dev)
        try:
            # 8. the BriStruNet forward; 9. serve through the inference CLI
            bristrunet, _ = forward_against_cpu(
                "BriStruNet forward", seeded_model("bristrunet", SEED + 8), ds, dev,
                BRISTRUNET_LAUNCHES)
            by_path = serve_through_cli(data_dir, exp_dir, bristrunet, len(ds), dev)
        finally:
            shutil.rmtree(exp_dir, ignore_errors=True)
        del bristrunet

        # 10. ptv3_pooled at the benched configuration; 11. flat ptv3 at its
        # default width; 12. ptv3_pooled served through the inference CLI
        pooled_counts = only(flash_attn=12)
        forward_against_cpu("ptv3_pooled forward",
                            seeded_model("ptv3_pooled", SEED + 10, **POOLED_BENCHED), ds, dev,
                            pooled_counts)
        flat_counts = only(flash_attn=8)
        forward_against_cpu("ptv3 forward", seeded_model("ptv3", SEED + 11), ds, dev,
                            flat_counts, profile=False)
        by_path |= serve_ptv3_pooled_through_cli(data_dir, len(ds), dev)
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
    # Per kernel and path: the launches of one pass at B=4 (phases 4, 6, 8,
    # 10 and 11) beside the times and bound summed over exactly those
    # launches' shapes (phases 3, 3b and 3c). The row's own numbers are those
    # of the BriStruNet forward, of the SSG train step for the backward
    # kernels, and of the ptv3_pooled forward for the flash-attention kernel.
    pass_counts = {SSG: fwd_counts, BRISTRUNET: BRISTRUNET_LAUNCHES, TRAIN: step_counts,
                   PTV3_POOLED: pooled_counts, PTV3: flat_counts}
    serves = {"ssg_serve_blocks": serve_counts, "ssg_train_cli": train_counts, **by_path}
    kernels = []
    for k in _kernels.KERNELS:
        backward = k.name in BACKWARD_KERNELS
        paths = {path: res.row(k.name, path, counts[k.name])
                 for path, counts in pass_counts.items()
                 if counts[k.name] and backward == (path == TRAIN)}
        kernels.append({
            "name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
            "max_abs_err": res.err[k.name],
            **paths[TRAIN if backward else PTV3_POOLED if k.name == "flash_attn"
                    else BRISTRUNET],
            "paths": paths,
            "launches_by_path": {path: c[k.name] for path, c in serves.items()},
        })
    summary = {"kernels": kernels}
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
