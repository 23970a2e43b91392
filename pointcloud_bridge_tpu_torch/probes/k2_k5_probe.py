#!/usr/bin/env python3
"""Measure design variants of K2 (ball query), K5 (exact k-NN) and K5c (k-NN
over C channels) on the card.

    python3 pointcloud_bridge_tpu_torch/probes/k2_k5_probe.py

Nothing here is on the port's main path. Each variant is csrc/ballq.cu or
csrc/knn.cu with one part changed by a textual edit, built on its own into
build/probes/ and launched with the wrapper's plan at the model shapes. The
variant marked "timing only" computes something else on purpose (no
candidate ever enters: the k-NN scan alone) and is not held to the plain
version; every other variant is held to it bit for bit. Times are device
ms a call from a CUDA graph of 20 calls.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from pointcloud_bridge_tpu_torch.ops import _kernels, grouping  # noqa: E402
from pointcloud_bridge_tpu_torch.probes.k1_k4_probe import build, device_ms, stream  # noqa: E402

OUT = ROOT / "build" / "probes"
# (name, exact, [(old, new), ...]); every old string must occur
BALL_VARIANTS = (
    ("kernel", True, []),
    ("unroll 2", True, [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 2;")]),
    ("unroll 8", True, [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 8;")]),
    ("12-byte loads", True, [(
        "for (int u = 0; u < kUnroll; ++u) p[u] = pts[t0 + u * 32 + lane];",
        "for (int u = 0; u < kUnroll; ++u) { const float* f = reinterpret_cast<const float*>("
        "pts + t0 + u * 32 + lane); const float2 xy = *reinterpret_cast<const float2*>(f); "
        "p[u] = make_float4(xy.x, xy.y, f[2], 0.f); }")]),
)
KNN_VARIANTS = (
    ("kernel", True, []),
    ("unroll 2", True, [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 2;")]),
    ("unroll 8", True, [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 8;")]),
    ("12-byte loads", True, [(
        "const float4 p = pts[t0 + u * 32 + lane];",
        "const float* f = reinterpret_cast<const float*>(pts + t0 + u * 32 + lane); "
        "const float2 xy = *reinterpret_cast<const float2*>(f); "
        "const float4 p = make_float4(xy.x, xy.y, f[2], 0.f);")]),
    ("no candidates: the scan alone (timing only)", False,
     [(": bound(kNoBound), count(0)", ": bound(0u), count(0)")]),
)

# K5c (pcb_knn_c in knn.cu): the width the models use compiled in, or read
# from the plan as any other width is; and its scan alone
KNN_C_VARIANTS = (
    ("kernel", True, []),
    ("C = 64 read from the plan", True, [("if (c == 64 && vec)", "if (false)")]),
    ("no candidates: the scan alone (timing only)", False,
     [(": bound(kNoBound), count(0)", ": bound(0u), count(0)")]),
)


def variants(source: str, table, tag: str = "") -> dict:
    """name -> (exact, the library of that variant of csrc/<source>), built
    as build/probes/<tag or the source's stem>_<i>.so: a library path is
    loaded once a process, so each table needs a tag of its own."""
    text = (_kernels.CSRC / source).read_text().replace(
        '#include "common.cuh"', f'#include "{_kernels.CSRC / "common.cuh"}"')
    libs = {}
    for name, exact, edits in table:
        variant = text
        for old, new in edits:
            if old not in variant:
                raise SystemExit(f"{source} variant {name}: the text to edit is gone")
            variant = variant.replace(old, new)
        stem = f"{tag or Path(source).stem}_{len(libs)}"
        OUT.mkdir(parents=True, exist_ok=True)
        (OUT / f"{stem}.cu").write_text(variant)
        libs[name] = (exact, build(OUT / f"{stem}.cu", stem))
    return libs


def probe_ball(dev) -> None:
    libs = variants("ballq.cu", BALL_VARIANTS)
    for _, lib in libs.values():
        lib.pcb_ball_query.argtypes = list(_kernels.BALL_QUERY.argtypes)
    gen = torch.Generator().manual_seed(2)
    for b, n, s, k, r in ((16, 4096, 1024, 32, 0.1), (4, 4096, 1024, 16, 0.1),
                          (4, 4096, 1024, 32, 0.2), (4, 1024, 512, 16, 0.2)):
        xyz = torch.rand(b, n, 3, generator=gen).to(dev)
        centers = xyz[:, :s].contiguous()
        want = grouping.ball_query_plain(r, k, xyz, centers)
        out = torch.empty(b, s, k, dtype=torch.int32, device=dev)
        plan = grouping._ball_plan(b, n, s, ((r, k),), _kernels.sm_count(dev.index))
        line = []
        for name, (exact, lib) in libs.items():
            def run(lib=lib):
                return lib.pcb_ball_query(xyz.data_ptr(), centers.data_ptr(), out.data_ptr(),
                                          None, None, plan, dev.index, stream())
            if run() != 0:
                raise SystemExit(f"ball query {name}: launch failed")
            torch.cuda.synchronize()
            if exact and not torch.equal(out, want):
                raise AssertionError(f"ball query {name} B={b} N={n} S={s}: disagrees")
            line.append(f"{name} {device_ms(run):.4f}")
        print(f"ball_query B={b} N={n} S={s} K={k} r={r} warps x queries {plan[3]}x{plan[4]}: "
              "device ms " + ", ".join(line), flush=True)


def probe_knn(dev) -> None:
    libs = variants("knn.cu", KNN_VARIANTS)
    for _, lib in libs.values():
        lib.pcb_knn.argtypes = list(_kernels.KNN.argtypes)
    gen = torch.Generator().manual_seed(3)
    for b, n, k in ((4, 4096, 32), (16, 4096, 32), (4, 512, 16)):
        xyz = torch.rand(b, n, 3, generator=gen).to(dev)
        want = grouping.knn_plain(xyz, xyz, k)
        idx = torch.empty(b, n, k, dtype=torch.int32, device=dev)
        d2 = torch.empty(b, n, k, device=dev)
        plan = grouping._knn_plan(b, n, n, k, _kernels.sm_count(dev.index))
        line = []
        for name, (exact, lib) in libs.items():
            def run(lib=lib):
                return lib.pcb_knn(xyz.data_ptr(), xyz.data_ptr(), idx.data_ptr(), d2.data_ptr(),
                                   plan, dev.index, stream())
            if run() != 0:
                raise SystemExit(f"knn {name}: launch failed")
            torch.cuda.synchronize()
            if exact and not (torch.equal(idx, want[1]) and torch.equal(d2, want[0])):
                raise AssertionError(f"knn {name} B={b} N={n}: disagrees")
            line.append(f"{name} {device_ms(run):.4f}")
        print(f"knn B={b} N=S={n} k={k} warps {plan[4]}: device ms "
              + ", ".join(line), flush=True)


def probe_knn_c(dev) -> None:
    """K5c at DGCNN's shapes (C = 64, N = S = 4096): each variant of
    KNN_C_VARIANTS, and the kernel with its tiles staged 4 bytes a copy as
    [C][tile] floats (the plan's vec = 0, the path of widths not a multiple
    of 4) in place of four channels a copy."""
    libs = variants("knn.cu", KNN_C_VARIANTS, "knn_c")
    for _, lib in libs.values():
        lib.pcb_knn_c.argtypes = list(_kernels.KNN_C.argtypes)
    gen = torch.Generator().manual_seed(4)
    for b, k in ((4, 20), (4, 64), (16, 20)):
        x = torch.randn(b, 4096, 64, generator=gen).to(dev)
        want = grouping.knn_plain(x, x, k)
        idx = torch.empty(b, 4096, k, dtype=torch.int32, device=dev)
        d2 = torch.empty(b, 4096, k, device=dev)
        sms = _kernels.sm_count(dev.index)
        line = []
        runs = [(name, exact, lib, True) for name, (exact, lib) in libs.items()]
        runs.append(("4-byte staging", True, libs["kernel"][1], False))
        for name, exact, lib, vec in runs:
            plan = grouping._knn_c_plan(b, 4096, 4096, k, 64, sms, vec)

            def run(lib=lib, plan=plan):
                return lib.pcb_knn_c(x.data_ptr(), x.data_ptr(), idx.data_ptr(), d2.data_ptr(),
                                     plan, dev.index, stream())
            if run() != 0:
                raise SystemExit(f"knn_c {name}: launch failed")
            torch.cuda.synchronize()
            if exact and not (torch.equal(idx, want[1]) and torch.equal(d2, want[0])):
                raise AssertionError(f"knn_c {name} B={b} k={k}: disagrees")
            line.append(f"{name} {device_ms(run):.4f}")
        print(f"knn_c B={b} N=S=4096 C=64 k={k}: device ms " + ", ".join(line), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k2_k5_probe: no CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    probe_ball(dev)
    probe_knn(dev)
    probe_knn_c(dev)


if __name__ == "__main__":
    main()
