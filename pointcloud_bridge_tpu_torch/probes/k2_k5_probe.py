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

K5c's first design, a warp a query (the kernel at one query a warp and
the launch the wrapper gave it then), is timed in turns with the kernel at
DGCNN's four shapes (``compare_k5c``; chip_smoke.py --neighbours calls it
too). K5c's early exit (``probe_knn_c_exit``) runs on normal features here
and on DGCNN's own through chip_smoke.py --k5c-exit.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from pointcloud_bridge_tpu_torch.ops import _kernels, grouping  # noqa: E402
from pointcloud_bridge_tpu_torch.probes.k1_k4_probe import build, device_ms, stream  # noqa: E402

# DGCNN's K5c shapes: (B, k) at C = 64, N = S = 4096
K5C_SHAPES = ((4, 20), (4, 64), (16, 20), (16, 64))

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


# K5c at 4 and 8 queries a warp, which the kernel is not compiled for (they
# were slower at every DGCNN shape): the check, the static_assert and the
# switch opened to them, and the channel loop unrolled 2 where Q > 2
SWITCH_DEFAULT = "    default:\n      return launch_knn_c<R, CC, VEC, 2>("
CHANNEL_LOOP = "#pragma unroll 4\n        for (int g = 1; g < c4; ++g) {"
WIDE_Q = [
    ('static_assert(Q == 1 || Q == 2, "1 or 2 queries a warp");',
     'static_assert(Q == 1 || Q == 2 || Q == 4 || Q == 8, "1, 2, 4 or 8 queries a warp");'),
    ("(queries != 1 && queries != 2)",
     "(queries != 1 && queries != 2 && queries != 4 && queries != 8)"),
    (SWITCH_DEFAULT, "".join(
        f"    case {q}:\n      return launch_knn_c<R, CC, VEC, {q}>(xyz, query, idx_out, d2_out, "
        "b, n, s, k, c, warps,\n                                         tile, device, stream);\n"
        for q in (4, 8)) + SWITCH_DEFAULT),
    (CHANNEL_LOOP, CHANNEL_LOOP.replace("unroll 4", "unroll (Q <= 2 ? 4 : 2)")),
]
# ... with 128 registers a thread at Q = 4 (512 threads a block) and 255 at
# Q = 8 (256 threads); without this edit every Q is held to 64 (1024)
REGISTERS_BY_Q = ("__launch_bounds__(1024)\n    knn_c_kernel(",
                  "__launch_bounds__(Q <= 2 ? 1024 : 2048 / Q)\n    knn_c_kernel(")
SCAN_ALONE = (": bound(kNoBound), count(0)", ": bound(0u), count(0)")

# K5c's launches past the wrapper's limits, by textual edits, each timed at
# its launches (warps, queries a warp, points a tile or None for the most
# that fits): Q = 4 and 8 at the most warps their registers allow and held
# to 64 registers a thread; the channel loop unrolled 2, 8 or fully; and the
# scan alone at Q = 2 and Q = 4
KNN_C_LAUNCH_VARIANTS = (
    ("Q = 4 and 8", True, WIDE_Q + [REGISTERS_BY_Q],
     ((16, 4, None), (16, 4, 128), (8, 4, None), (8, 4, 128), (8, 8, None), (8, 8, 128),
      (4, 8, None))),
    ("Q = 4 and 8 at 64 registers", True, WIDE_Q, ((32, 4, None), (16, 8, None))),
    ("channel loop unrolled 2", True,
     [(CHANNEL_LOOP, CHANNEL_LOOP.replace("unroll 4", "unroll 2"))], ((32, 2, None),)),
    ("channel loop unrolled 8", True,
     [(CHANNEL_LOOP, CHANNEL_LOOP.replace("unroll 4", "unroll 8"))], ((32, 2, None),)),
    ("channel loop unrolled fully", True,
     [(CHANNEL_LOOP, CHANNEL_LOOP.replace("unroll 4", "unroll"))], ((32, 2, None),)),
    ("no candidates: the scan alone (timing only)", False, [SCAN_ALONE], ((32, 2, None),)),
    ("no candidates at Q = 4: the scan alone (timing only)", False,
     WIDE_Q + [REGISTERS_BY_Q, SCAN_ALONE], ((16, 4, None),)),
)


def raw_plan(b: int, n: int, s: int, k: int, c: int, warps: int, queries: int, tile=None):
    """pcb_knn_c's plan laid out here, past the wrapper's checks: ``tile``
    None for the most that fits (grouping.knn_c_tile); float4 staging."""
    tile = tile or grouping.knn_c_tile(n, c, warps, queries)
    return (ctypes.c_int * len(grouping.KNN_C_PLAN))(b, n, s, k, c, warps, queries, tile, 1)


def probe_knn_c_launches(dev) -> None:
    """K5c at DGCNN's shapes: each variant of KNN_C_LAUNCH_VARIANTS at its
    launches, in turns with the kernel at the wrapper's plan."""
    libs = variants("knn.cu", [v[:3] for v in KNN_C_LAUNCH_VARIANTS], "knn_c_launch")
    libs["kernel"] = (True, _kernels.library())
    for _, lib in libs.values():
        lib.pcb_knn_c.argtypes = list(_kernels.KNN_C.argtypes)
    launches = {v[0]: v[3] for v in KNN_C_LAUNCH_VARIANTS}
    gen = torch.Generator().manual_seed(7)
    sms = _kernels.sm_count(dev.index)
    for b, k in K5C_SHAPES:
        x = torch.randn(b, 4096, 64, generator=gen).to(dev)
        want = grouping.knn_plain(x, x, k)
        idx = torch.empty(b, 4096, k, dtype=torch.int32, device=dev)
        d2 = torch.empty(b, 4096, k, device=dev)
        plan = grouping._knn_c_plan(b, 4096, 4096, k, 64, sms, True)
        kernel = ("kernel", True, libs["kernel"][1], plan)
        runs = [kernel]
        for name, (exact, lib) in libs.items():
            for warps, queries, tile in launches.get(name, ()):
                launch = raw_plan(b, 4096, 4096, k, 64, warps, queries, tile)
                runs.append((f"{name} {warps}x{queries} {launch[7]}", exact, lib, launch))
        runs.append(kernel)
        line = []
        for name, exact, lib, plan in runs:
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
        del x, want


# K5c with an exact early exit: every partial sum only grows (each term is
# >= 0 and rounded addition is monotone), so once no pair of the group is
# below its query's bound after 16 more channels, none can enter and the
# group's other channels are skipped; one vote a 16 channels
EXIT_LOOP = CHANNEL_LOOP + """
          float4 p[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) p[u] = p4[(size_t)g * padded + u * 32];
#pragma unroll
          for (int i = 0; i < Q; ++i) {
            const float4 qv = q4[i * c4 + g];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) acc[i][u] = sq_add4(acc[i][u], qv, p[u]);
          }
        }
"""
EXIT_VARIANT = ("exit every 16 channels", True, [(EXIT_LOOP, """bool open = true;
        for (int g0 = 1; g0 < c4; g0 += 4) {
          const int g1 = min(g0 + 4, c4);
#pragma unroll 4
          for (int g = g0; g < g1; ++g) {
            float4 p[kUnroll];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) p[u] = p4[(size_t)g * padded + u * 32];
#pragma unroll
            for (int i = 0; i < Q; ++i) {
              const float4 qv = q4[i * c4 + g];
#pragma unroll
              for (int u = 0; u < kUnroll; ++u) acc[i][u] = sq_add4(acc[i][u], qv, p[u]);
            }
          }
          if (g1 == c4) break;
          bool alive = false;
#pragma unroll
          for (int i = 0; i < Q; ++i) {
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) alive |= __float_as_uint(acc[i][u]) < sel[i].bound;
          }
          open = __any_sync(kFull, alive);
          if (!open) break;
        }
        if (!open) continue;  // no pair of the group can enter
""")])


def probe_knn_c_exit(dev, cases=()) -> None:
    """K5c and its early-exit variant (EXIT_VARIANT) in turns, kernel,
    variant, variant, kernel, at the wrapper's plan: on ``cases``, [(label,
    features [B, 4096, 64], k)] handed over by the caller (chip_smoke.py
    --k5c-exit: the features DGCNN's graphs are built over), and on normal
    features; each held to knn_plain bit for bit."""
    lib = variants("knn.cu", [EXIT_VARIANT], "knn_c_exit")[EXIT_VARIANT[0]][1]
    lib.pcb_knn_c.argtypes = list(_kernels.KNN_C.argtypes)
    kernel = _kernels.library()
    gen = torch.Generator().manual_seed(8)
    cases = list(cases) + [
        (f"normal B={b}", torch.randn(b, 4096, 64, generator=gen).to(dev), k)
        for b, k in K5C_SHAPES]
    sms = _kernels.sm_count(dev.index)
    totals = {}
    for label, x, k in cases:
        b = x.shape[0]
        want = grouping.knn_plain(x, x, k)
        idx = torch.empty(b, 4096, k, dtype=torch.int32, device=dev)
        d2 = torch.empty(b, 4096, k, device=dev)
        plan = grouping._knn_c_plan(b, 4096, 4096, k, 64, sms, True)
        times = []
        for name, use in (("kernel", kernel), ("exit", lib), ("exit", lib), ("kernel", kernel)):
            def run(use=use):
                return use.pcb_knn_c(x.data_ptr(), x.data_ptr(), idx.data_ptr(), d2.data_ptr(),
                                     plan, dev.index, stream())
            if run() != 0:
                raise SystemExit(f"knn_c {name}: launch failed")
            torch.cuda.synchronize()
            if not (torch.equal(idx, want[1]) and torch.equal(d2, want[0])):
                raise AssertionError(f"knn_c {name} on {label}: disagrees")
            times.append((name, device_ms(run)))
        kern = (times[0][1] + times[3][1]) / 2
        ext = (times[1][1] + times[2][1]) / 2
        group = label.split(" conv")[0]
        totals[group] = [a + c for a, c in zip(totals.get(group, (0.0, 0.0)), (kern, ext))]
        print(f"knn_c {label} k={k}: device ms in turns "
              + ", ".join(f"{name} {ms:.4f}" for name, ms in times)
              + f"; exit / kernel {ext / kern:.3f}", flush=True)
        del x, want
    for group, (kern, ext) in totals.items():
        print(f"knn_c {group}: summed kernel {kern:.4f} ms, exit {ext:.4f} ms", flush=True)


def first_design_plan(b: int, n: int, s: int, k: int, c: int, sms: int, vec: bool):
    """K5c's first design: a warp a query, at the warps of
    grouping.neighbour_launch and the most tile that leaves (32 warps and
    384-point tiles at DGCNN's shapes), as the wrapper planned it before
    the kernel took two queries a warp."""
    return grouping._knn_c_plan(b, n, s, k, c, sms, vec,
                                grouping.neighbour_launch(b, s, sms), None, 1)


def compare_k5c(dev, seed: int = 6, shapes=K5C_SHAPES) -> dict:
    """K5c's first design (first_design_plan) and the kernel at the
    wrapper's plan in turns, first, kernel, kernel, first, at each (B, k) of
    ``shapes`` (C = 64, N = S = 4096, normal features): each held to
    knn_plain bit for bit, device ms a call from a CUDA graph of 20 calls.
    -> {(B, k): (first design ms, kernel ms)}, each the mean of its two
    turns."""
    lib = _kernels.library()
    lib.pcb_knn_c.argtypes = list(_kernels.KNN_C.argtypes)
    sms = _kernels.sm_count(dev.index)
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for b, k in shapes:
        x = torch.randn(b, 4096, 64, generator=gen).to(dev)
        want = grouping.knn_plain(x, x, k)
        idx = torch.empty(b, 4096, k, dtype=torch.int32, device=dev)
        d2 = torch.empty(b, 4096, k, device=dev)
        plans = {"first": first_design_plan(b, 4096, 4096, k, 64, sms, True),
                 "kernel": grouping._knn_c_plan(b, 4096, 4096, k, 64, sms, True)}

        def run(name):
            return lib.pcb_knn_c(x.data_ptr(), x.data_ptr(), idx.data_ptr(), d2.data_ptr(),
                                 plans[name], dev.index, stream())
        for name in plans:
            if run(name) != 0:
                raise SystemExit(f"knn_c {name} design: launch failed")
            torch.cuda.synchronize()
            if not (torch.equal(idx, want[1]) and torch.equal(d2, want[0])):
                raise AssertionError(f"knn_c {name} design B={b} k={k}: disagrees")
        turns = [(name, device_ms(lambda name=name: run(name)))
                 for name in ("first", "kernel", "kernel", "first")]
        first = [ms for name, ms in turns if name == "first"]
        kernel = [ms for name, ms in turns if name == "kernel"]
        out[(b, k)] = (sum(first) / 2, sum(kernel) / 2)
        print(f"knn_c B={b} N=S=4096 C=64 k={k}: device ms in turns, "
              + ", ".join(f"{name} {ms:.4f}" for name, ms in turns)
              + f"; kernel / first {out[(b, k)][1] / out[(b, k)][0]:.3f}", flush=True)
        del x, want
    return out


def variants(source: str, table, tag: str = "") -> dict:
    """name -> (exact, the library of that variant of csrc/<source>), built
    as build/probes/<tag or the source's stem>_<i>.so, one nvcc a variant,
    all at once: a library path is loaded once a process, so each table
    needs a tag of its own."""
    text = (_kernels.CSRC / source).read_text().replace(
        '#include "common.cuh"', f'#include "{_kernels.CSRC / "common.cuh"}"')
    OUT.mkdir(parents=True, exist_ok=True)
    sources = {}
    for name, exact, edits in table:
        variant = text
        for old, new in edits:
            if old not in variant:
                raise SystemExit(f"{source} variant {name}: the text to edit is gone")
            variant = variant.replace(old, new)
        stem = f"{tag or Path(source).stem}_{len(sources)}"
        (OUT / f"{stem}.cu").write_text(variant)
        sources[name] = (exact, stem)
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        built = {name: pool.submit(build, OUT / f"{stem}.cu", stem)
                 for name, (_, stem) in sources.items()}
        return {name: (sources[name][0], lib.result()) for name, lib in built.items()}


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
    for b, k in K5C_SHAPES:
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
    probe_knn_c_launches(dev)
    probe_knn_c_exit(dev)
    compare_k5c(dev)


if __name__ == "__main__":
    main()
