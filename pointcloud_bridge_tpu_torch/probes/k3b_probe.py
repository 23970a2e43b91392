#!/usr/bin/env python3
"""Measure design variants of K3b (the group backward) on the card.

    python3 pointcloud_bridge_tpu_torch/probes/k3b_probe.py

Nothing here is on the port's main path. At the train steps' shapes (SSG's
sa2 and sa3, BriStruNet's six levels, pointnet2_msg's six, B=4; DGCNN's
index_points backward at k = 20) it times, in device ms a call from a CUDA
graph of 20 calls, textual variants of csrc/group_bwd.cu, each exact one
held bit for bit to ``grouping.group_backward_order``:

- the kernel as it is; its counting sort alone and its fold alone (timing
  only: the fold reads the buckets the kernel's own call left in the same
  scratch); the kernel with its count, scan and place in one block a
  batch element (the plan's ``split`` at 1, as the wrapper picks it for
  S * K <= GROUP_BWD_SLICE);
- the fold with 4 slots loaded ahead instead of 16 or 32, and with 8 warps
  a block instead of 4;
- the count and place with 8 slots a thread loaded ahead instead of 4;

beside ``index_add_`` with zeroing, the library call chip_smoke.py times.
``compare(dev)`` is what ``chip_smoke.py --grouping`` calls after its
cases; run as a script, it does the same after printing the card.
"""

from __future__ import annotations

import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from pointcloud_bridge_tpu_torch.ops import _kernels, grouping  # noqa: E402
from pointcloud_bridge_tpu_torch.probes.k1_k4_probe import (  # noqa: E402
    OUT,
    build,
    device_ms,
    stream,
)

# (path, B, ((N, S, K, radius, C), ...)); C the feature channels a level
# sends back (c0 = 3), or None for an index_points backward over a k-NN
# graph (c0 = 0, C = 64)
PATHS = (
    ("SSG step", 4, ((1024, 256, 32, 0.2, 128), (256, 64, 32, 0.4, 256))),
    ("BriStruNet step", 4, ((4096, 1024, 16, 0.1, 3), (4096, 1024, 32, 0.2, 3),
                            (1024, 512, 16, 0.2, 256), (1024, 512, 32, 0.4, 256),
                            (512, 128, 16, 0.4, 512), (512, 128, 32, 0.8, 512))),
    ("pointnet2_msg step", 4, ((1024, 256, 16, 0.1, 96), (1024, 256, 32, 0.2, 96),
                               (256, 64, 16, 0.2, 256), (256, 64, 32, 0.4, 256),
                               (64, 16, 16, 0.4, 512), (64, 16, 32, 0.8, 512))),
    ("DGCNN index_points", 4, ((4096, 4096, 20, None, 64),)),
)
# (name, exact, [(old, new), ...]) of csrc/group_bwd.cu with its counting
# sort written in place (source_text); every old string must occur
VARIANTS = (
    ("kernel", True, []),
    ("fold alone (timing only)", False,
     [("    group_bwd_sort<<<b, kScanThreads, smem, st>>>(idx, ends, bucket, n, t);\n", ""),
      ("    group_bwd_count<<<sort_grid, kSortThreads, smem, st>>>(idx, hist, n, t, per);\n"
       "    group_bwd_scan<<<b, kScanThreads, smem, st>>>(hist, ends, n, split);\n"
       "    group_bwd_place<<<sort_grid, kSortThreads, smem, st>>>(idx, hist, bucket, n, t, per);\n",
       "")]),
    ("sort alone (timing only)", False,
     [("  const dim3 grid(", "  return (int)cudaGetLastError();\n  const dim3 grid(")]),
    ("fold 4 ahead", True, [("V == 4 ? 16 : 32", "V == 4 ? 4 : 4")]),
    ("sort 8 slots a thread", True, [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 8;")]),
    ("fold 8 warps a block", True,
     [("constexpr int kFoldThreads = 128;", "constexpr int kFoldThreads = 256;")]),
)


def source_text() -> str:
    """csrc/group_bwd.cu with the counting sort it includes
    (csrc/group_sort.cuh) written in place, so that one text holds every
    line VARIANTS edits, and common.cuh included by its path."""
    common = f'#include "{_kernels.CSRC / "common.cuh"}"'
    sort = (_kernels.CSRC / "group_sort.cuh").read_text().replace('#include "common.cuh"', common)
    return (_kernels.CSRC / "group_bwd.cu").read_text().replace(
        '#include "common.cuh"', common).replace('#include "group_sort.cuh"', sort)


def variants() -> dict:
    """name -> (exact, the library of that variant of csrc/group_bwd.cu)."""
    text = source_text()
    OUT.mkdir(parents=True, exist_ok=True)
    sources = []
    for i, (name, _, edits) in enumerate(VARIANTS):
        variant = text
        for old, new in edits:
            if old not in variant:
                raise SystemExit(f"group_bwd.cu variant {name}: the text to edit is gone")
            variant = variant.replace(old, new)
        (OUT / f"group_bwd_{i}.cu").write_text(variant)
        sources.append(OUT / f"group_bwd_{i}.cu")
    # the variants build side by side, an nvcc each
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(lambda src: build(src, src.stem), sources))
    libs = {}
    for (name, exact, _), lib in zip(VARIANTS, built):
        lib.pcb_group_backward.argtypes = list(_kernels.GROUP_BWD.argtypes)
        libs[name] = (exact, lib)
    return libs


def case(dev, rng, b, n, s, k, r, c):
    """g, idx, c0, c1 of one level: ball-query indices over a uniform cloud
    onto its first s points, or the k-NN graph of normal features."""
    if r is None:
        x = torch.from_numpy(rng.normal(size=(b, n, 3)).astype(np.float32)).to(dev)
        idx = grouping.knn(x, k=k)
        return torch.from_numpy(rng.normal(size=(b, s, k, c)).astype(np.float32)).to(dev), idx, 0, c
    xyz = torch.from_numpy(rng.uniform(size=(b, n, 3)).astype(np.float32)).to(dev)
    idx = grouping.ball_query_cuda(r, k, xyz, xyz[:, :s].contiguous())
    g = torch.from_numpy(rng.normal(size=(b, s, k, 3 + c)).astype(np.float32)).to(dev)
    return g, idx, 3, 3 + c


def compare(dev) -> None:
    """Each path's levels under every variant, device ms a call, the
    longest bucket of each level, and the sums a path."""
    _kernels.library()
    libs = variants()
    libs["one block a batch element (split 1)"] = libs["kernel"]
    sms = _kernels.sm_count(dev.index)
    rng = np.random.default_rng(12)
    for path, b, levels in PATHS:
        sums: dict = {}
        for n, s, k, r, c in levels:
            g, idx, c0, c1 = case(dev, rng, b, n, s, k, r, c)
            want = grouping.group_backward_order(g, idx, n, c0, c1)
            split = grouping.group_backward_split(b, s, k, sms)
            plans = {name: grouping._group_backward_plan(b, n, s, k, g.shape[-1], c0, c1,
                                                         1 if "one block" in name else split)
                     for name in libs}
            chunks = grouping.group_backward_chunks(c1 - c0, plans["kernel"][7])
            work = torch.empty(grouping.group_backward_work(b, n, s, k, chunks, split),
                               dtype=torch.int32, device=dev)
            out = torch.empty(b, n, c1 - c0, device=dev)
            longest = int(torch.bincount((idx.clamp(0, n - 1).long()
                                          + torch.arange(b, device=dev).view(b, 1, 1) * n
                                          ).reshape(-1)).max())
            line = []
            for name, (exact, lib) in libs.items():
                def run(lib=lib, plan=plans[name]):
                    return lib.pcb_group_backward(g.data_ptr(), idx.data_ptr(), out.data_ptr(),
                                                  work.data_ptr(), plan, dev.index, stream())
                if run() != 0:
                    raise SystemExit(f"group_bwd {name}: launch failed")
                torch.cuda.synchronize()
                if exact and not torch.equal(out, want):
                    raise AssertionError(f"group_bwd {name} {path} N={n} S={s} K={k}: not the "
                                         "bits of group_backward_order")
                ms = device_ms(run)
                sums[name] = sums.get(name, 0.0) + ms
                line.append(f"{name} {ms:.4f}")
            rows = g[..., c0:c1].reshape(-1, c1 - c0).contiguous()
            flat = (idx.clamp(0, n - 1).long()
                    + torch.arange(b, device=dev).view(b, 1, 1) * n).reshape(-1)
            acc = torch.empty((b * n, c1 - c0), device=dev)
            ms = device_ms(lambda: acc.zero_().index_add_(0, flat, rows))
            sums["index_add_"] = sums.get("index_add_", 0.0) + ms
            line.append(f"index_add_ {ms:.4f}")
            print(f"group_bwd {path} N={n} S={s} K={k} r={r} [{c0},{c1}) longest bucket "
                  f"{longest}: device ms " + ", ".join(line), flush=True)
        print(f"group_bwd {path}, sum of its levels: device ms "
              + ", ".join(f"{name} {ms:.4f}" for name, ms in sums.items()), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k3b_probe: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    compare(torch.device("cuda", 0))


if __name__ == "__main__":
    main()
