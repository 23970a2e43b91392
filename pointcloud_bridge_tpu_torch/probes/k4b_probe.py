#!/usr/bin/env python3
"""Measure design variants of K4b (the interpolation backward) on the card.

    python3 pointcloud_bridge_tpu_torch/probes/k4b_probe.py

Nothing here is on the port's main path. At the train steps' shapes (SSG,
k=3, and BriStruNet, k=4, at B=4 and B=16) it times, in device ms a call
from a CUDA graph of 20 calls, each result held to the plain version within
1e-5 * max|plain|:

- design (a), csrc/interp_bwd.cu, the owner computes: at 8, 16, 32 and 64
  df rows a block (the wrapper picks one), and as textual variants: 4 or 16
  g rows loaded ahead of the adds (8 in the kernel), and windows of 1024 and
  8192 entries (4096 in the kernel); k4b_sort.cu beside this file, the
  window's list sorted by row in shared memory (a stable counting sort)
  before each warp adds its own rows' entries, a row's sum in registers; and
  k4b_inverse.cu, the inverse of the selection built once a batch element
  into scratch, then a warp a row that sorts its entries and sums them;
- design (b), k4b_scatter.cu beside this file: a memset of df, then a warp
  a query row that adds w * g into the k source rows by 16-byte float
  reductions, at 1, 2 and 4 rows a warp.

``compare(dev)`` is what ``chip_smoke.py --interp-backward`` calls after its
cases; run as a script, it does the same after printing the card.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from pointcloud_bridge_tpu_torch.ops import _kernels, interpolate  # noqa: E402
from pointcloud_bridge_tpu_torch.probes.k1_k4_probe import (  # noqa: E402
    OUT,
    build,
    device_ms,
    stream,
)

TOL = 1e-5  # of max|plain|: the plain version adds with atomics in its own order
# (path, B, k, ((N, S, D) of fp3, fp2, fp1))
PATHS = (
    ("SSG B=4", 4, 3, ((256, 64, 512), (1024, 256, 256), (4096, 1024, 128))),
    ("SSG B=16", 16, 3, ((256, 64, 512), (1024, 256, 256), (4096, 1024, 128))),
    ("BriStruNet B=4", 4, 4, ((512, 128, 1024), (1024, 512, 256), (4096, 1024, 256))),
    ("BriStruNet B=16", 16, 4, ((512, 128, 1024), (1024, 512, 256), (4096, 1024, 256))),
)
# (name, exact, [(old, new), ...]) of csrc/interp_bwd.cu; every old string
# must occur. A variant marked "timing only" leaves part of the work out on
# purpose and is not held to the plain version.
OWNER_VARIANTS = (
    ("(a) 4 g rows ahead", True, [("constexpr int kAhead = 8;", "constexpr int kAhead = 4;")]),
    ("(a) 16 g rows ahead", True, [("constexpr int kAhead = 8;", "constexpr int kAhead = 16;")]),
    ("(a) windows of 1024", True, [("constexpr int kSteps = 16;", "constexpr int kSteps = 4;")]),
    ("(a) windows of 8192", True, [("constexpr int kSteps = 16;", "constexpr int kSteps = 32;")]),
    ("(a) windows of 2048", True, [("constexpr int kSteps = 16;", "constexpr int kSteps = 8;")]),
    ("(a) three blocks an SM (<= 85 registers)", True,
     [("__launch_bounds__(kThreads)", "__launch_bounds__(kThreads, 3)")]),
    ("(a) windows of 2048, three blocks an SM", True,
     [("constexpr int kSteps = 16;", "constexpr int kSteps = 8;"),
      ("__launch_bounds__(kThreads)", "__launch_bounds__(kThreads, 3)")]),
    ("(a) the scan alone, no adds (timing only)", False,
     [("      if (!mine) continue;\n", "      continue;\n")]),
    ("(a) no g loaded (timing only)", False,
     [("gv[i] = live ? __ldg(", "gv[i] = false ? __ldg(")]),
)
SCATTER_ROWS = (1, 2, 4)


def owner_variants() -> dict:
    """name -> the library of that variant of csrc/interp_bwd.cu."""
    text = (_kernels.CSRC / "interp_bwd.cu").read_text().replace(
        '#include "common.cuh"', f'#include "{_kernels.CSRC / "common.cuh"}"')
    libs = {}
    for name, exact, edits in OWNER_VARIANTS:
        variant = text
        for old, new in edits:
            if old not in variant:
                raise SystemExit(f"interp_bwd.cu variant {name}: the text to edit is gone")
            variant = variant.replace(old, new)
        stem = f"interp_bwd_{len(libs)}"
        OUT.mkdir(parents=True, exist_ok=True)
        (OUT / f"{stem}.cu").write_text(variant)
        lib = build(OUT / f"{stem}.cu", stem)
        lib.pcb_interpolate_backward.argtypes = list(_kernels.INTERP_BWD.argtypes)
        libs[name] = (exact, lib)
    return libs


def probe_library(source: str, symbol: str):
    """The library of a variant beside this file, its entry bound with the
    kernel's argument types."""
    text = (Path(__file__).with_name(source)).read_text().replace(
        '#include "common.cuh"', f'#include "{_kernels.CSRC / "common.cuh"}"')
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / source).write_text(text)
    lib = build(OUT / source, Path(source).stem)
    getattr(lib, symbol).argtypes = list(_kernels.INTERP_BWD.argtypes)
    return lib


def level(dev, rng, b, k, n, s, d):
    """The forward kernel's kept selection of a random cloud onto its first
    s points, and a random g -> (g, idx, w)."""
    dst = torch.from_numpy(rng.uniform(size=(b, n, 3)).astype(np.float32)).to(dev)
    f = torch.zeros(b, s, 4, device=dev)
    _, idx, w = interpolate.interpolate_cuda(dst, dst[:, :s].contiguous(), f, k, True)
    return torch.from_numpy(rng.normal(size=(b, n, d)).astype(np.float32)).to(dev), idx, w


def compare(dev) -> None:
    """Each path's three levels under every design, device ms a call, and
    the sums a path."""
    _kernels.library()
    libs = owner_variants()
    libs["(a) the list sorted by row first (k4b_sort.cu)"] = (
        True, probe_library("k4b_sort.cu", "pcb_interpolate_backward"))
    scatter = probe_library("k4b_scatter.cu", "pcb_interp_bwd_scatter")
    inverse = probe_library("k4b_inverse.cu", "pcb_k4b_inverse")
    inverse.pcb_k4b_inverse.argtypes = (list(_kernels.INTERP_BWD.argtypes[:4]) + [_kernels._P]
                                        + list(_kernels.INTERP_BWD.argtypes[4:]))
    sms = _kernels.sm_count(dev.index)
    rng = np.random.default_rng(10)
    for path, b, k, levels in PATHS:
        sums: dict = {}
        for n, s, d in levels:
            g, idx, w = level(dev, rng, b, k, n, s, d)
            want = interpolate.interpolate_backward_plain(g, idx, w, s)
            scale = want.abs().max().item()
            df = torch.empty(b, s, d, device=dev)

            def launcher(fn, plan):
                return lambda: fn(g.data_ptr(), idx.data_ptr(), w.data_ptr(), df.data_ptr(), plan,
                                  dev.index, stream())

            runs = {}  # name -> (held to the plain version, launch)
            chosen = interpolate.bwd_rows(b, s, d, sms)
            for rows in interpolate._BWD_ROWS:
                plan = interpolate._interp_bwd_plan(b, n, s, d, k, True, sms, rows)
                runs[f"(a) {rows} rows"] = True, launcher(_kernels.INTERP_BWD.fn, plan)
            plan = interpolate._interp_bwd_plan(b, n, s, d, k, True, sms, chosen)
            for name, (exact, lib) in libs.items():
                runs[name] = exact, launcher(lib.pcb_interpolate_backward, plan)
            scratch = torch.empty(b * (n * k + s + 1), dtype=torch.int32, device=dev)
            runs["(a) the inverse built once an element, then a warp a row (k4b_inverse.cu)"] = (
                True, lambda: inverse.pcb_k4b_inverse(g.data_ptr(), idx.data_ptr(), w.data_ptr(),
                                                      df.data_ptr(), scratch.data_ptr(), plan,
                                                      dev.index, stream()))
            for rows in SCATTER_ROWS:
                splan = (type(plan))(*plan)
                splan[5] = rows
                runs[f"(b) {rows} rows a warp"] = True, launcher(scatter.pcb_interp_bwd_scatter,
                                                                 splan)
            line = []
            for name, (exact, run) in runs.items():
                if run() != 0:
                    raise SystemExit(f"interp_bwd {name}: launch failed")
                torch.cuda.synchronize()
                err = (df.double() - want.double()).abs().max().item()
                if exact and err > TOL * scale:
                    raise AssertionError(f"interp_bwd {name} {path} N={n} S={s} D={d}: max|err| "
                                         f"{err:.3g} over {TOL} of {scale:.3g}")
                ms = device_ms(run)
                sums[name] = sums.get(name, 0.0) + ms
                if name == f"(a) {chosen} rows":
                    picked = "(a) as the wrapper picks"
                    sums[picked] = sums.get(picked, 0.0) + ms
                line.append(f"{name} {ms:.4f}")
            print(f"interp_bwd {path} N={n} S={s} D={d} k={k} (the wrapper picks {chosen} rows): "
                  "device ms " + ", ".join(line), flush=True)
        print(f"interp_bwd {path}, sum of three levels: device ms "
              + ", ".join(f"{name} {ms:.4f}" for name, ms in sums.items()), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k4b_probe: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    compare(torch.device("cuda", 0))


if __name__ == "__main__":
    main()
