#!/usr/bin/env python3
"""Measure design variants of K1 (FPS) and K4 (interpolation) on the card.

    python3 pointcloud_bridge_tpu_torch/probes/k1_k4_probe.py

Nothing here is on the port's main path. K1's variants are in
k1_probe.cu beside this file (see its header): the kernel's design with clock64()
stamps of each phase of a step, a 64-bit shared-atomic block stage, points
blocked per thread with ballots, and thread-block clusters of 2, 4 and 8
blocks a row. K4's variants are csrc/interp.cu with one of its parts taken
out or forced by a textual edit: the deferred insertion at every lane
count, insertion in each step at every lane count, and no group bound.
Each variant is held to the plain version (bit for bit for FPS, within 1e-5
for interpolation); times are device ms a call from a CUDA graph of 20
calls. Builds go to build/probes/.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from pointcloud_bridge_tpu_torch.ops import _kernels, interpolate, sampling  # noqa: E402

OUT = ROOT / "build" / "probes"
P, I = ctypes.c_void_p, ctypes.c_int
# K4's text edits: (name, [(old, new), ...]); every old string must occur
INTERP_VARIANTS = (
    ("kernel", []),
    ("deferred at every G", [("constexpr bool kDefer = G <= 8;", "constexpr bool kDefer = true;")]),
    ("each step at every G", [("constexpr bool kDefer = G <= 8;", "constexpr bool kDefer = false;")]),
    ("no bound", [("v[u] <= td) pending", "true) pending")]),
)


def build(source: Path, name: str) -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    so = OUT / f"{name}.so"
    res = subprocess.run(
        ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-fmad=false", "-o", str(so), str(source)],
        capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"nvcc failed on {source}:\n{res.stdout}\n{res.stderr}")
    return ctypes.CDLL(str(so))


def device_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device ms a call: ``calls`` calls captured in a CUDA graph (fn reads
    the current stream when it is called)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        e.record()
        e.synchronize()
        times.append(a.elapsed_time(e) / calls)
    return statistics.median(times)


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def probe_fps(dev) -> None:
    lib = build(Path(__file__).resolve().parent / "k1_probe.cu", "k1_probe")
    for name in ("probe_launch", "probe3_launch", "probe4_launch"):
        getattr(lib, name).argtypes = [P, P, P, I, I, I, I, I, P, P]
    lib.cluster_launch.argtypes = [P, P, P, I, I, I, I, I, I, P]
    gen = torch.Generator().manual_seed(0)
    for n, npoint, threads in ((4096, 1024, 512), (1024, 512, 128), (512, 128, 128), (256, 64, 32)):
        b = 4
        xyz = torch.rand(b, n, 3, generator=gen).to(dev)
        zero = torch.zeros(b, dtype=torch.int32, device=dev)
        want = sampling.fps_plain(xyz, npoint, zero)
        out = torch.empty(b, npoint, dtype=torch.int32, device=dev)
        clocks = torch.zeros(10, dtype=torch.int64, device=dev)
        ppt = sampling._pow2_at_least(-(-n // threads))
        for label, fn in (("strided, two redux a stage", lib.probe_launch),
                          ("64-bit shared atomicMax", lib.probe3_launch),
                          ("blocked, redux and ballot", lib.probe4_launch)):
            def run(fn=fn):
                return fn(xyz.data_ptr(), zero.data_ptr(), out.data_ptr(), b, n, npoint, threads,
                          ppt, clocks.data_ptr(), stream())
            out.zero_()
            if run() != 0:
                raise SystemExit(f"fps {label}: launch failed")
            torch.cuda.synchronize()
            ok = torch.equal(out, want)
            c = [round(x) for x in (clocks.double() / npoint).tolist()]
            print(f"fps B={b} {n}->{npoint} {threads}x{ppt} {label}: exact {ok}, device "
                  f"{device_ms(run):.4f} ms; cycles a step, warp 0 [centroid, distances, warp "
                  f"argmax, barrier, block argmax] {c[:5]}, last warp {c[5:]}", flush=True)
        for c_, t, p in ((2, 256, 8), (2, 512, 4), (4, 128, 8), (4, 256, 4), (8, 128, 4),
                         (2, 64, 8), (4, 32, 8)):
            if c_ * t * p < n or c_ * t * p >= 2 * n:
                continue

            def run(c_=c_, t=t, p=p):
                return lib.cluster_launch(xyz.data_ptr(), zero.data_ptr(), out.data_ptr(), b, n,
                                          npoint, t, p, c_, stream())
            out.zero_()
            err = run()
            torch.cuda.synchronize()
            if err:
                print(f"fps B={b} {n}->{npoint} cluster of {c_}: launch error {err}", flush=True)
                continue
            print(f"fps B={b} {n}->{npoint} cluster of {c_} x {t} threads x {p}: exact "
                  f"{torch.equal(out, want)}, device {device_ms(run):.4f} ms", flush=True)


def probe_interp(dev) -> None:
    text = (_kernels.CSRC / "interp.cu").read_text().replace(
        '#include "common.cuh"', f'#include "{_kernels.CSRC / "common.cuh"}"')
    libs = {}
    for name, edits in INTERP_VARIANTS:
        variant = text
        for old, new in edits:
            if old not in variant:
                raise SystemExit(f"interp variant {name}: the text to edit is gone")
            variant = variant.replace(old, new)
        path = OUT / f"interp_{len(libs)}.cu"
        OUT.mkdir(parents=True, exist_ok=True)
        path.write_text(variant)
        lib = build(path, f"interp_{len(libs)}")
        lib.pcb_interpolate.argtypes = list(_kernels.INTERPOLATE.argtypes)
        libs[name] = lib
    gen = torch.Generator().manual_seed(1)
    for b, k, levels in ((4, 3, ((256, 64, 512), (1024, 256, 256), (4096, 1024, 128))),
                         (4, 4, ((512, 128, 1024), (1024, 512, 256), (4096, 1024, 256))),
                         (16, 3, ((256, 64, 512), (1024, 256, 256), (4096, 1024, 128)))):
        for n, s, d in levels:
            dst = torch.rand(b, n, 3, generator=gen).to(dev)
            src = dst[:, :s].contiguous()
            f = torch.randn(b, s, d, generator=gen).to(dev)
            want = interpolate.interpolate_plain(dst, src, f, k)[0]
            out = torch.empty(b, n, d, device=dev)
            plan = interpolate._interp_plan(b, n, s, d, k, d % 4 == 0,
                                            interpolate._sm_count(dev.index))
            line = []
            for name, lib in libs.items():
                def run(lib=lib):
                    return lib.pcb_interpolate(dst.data_ptr(), src.data_ptr(), f.data_ptr(),
                                               out.data_ptr(), None, None, plan, dev.index,
                                               stream())
                if run() != 0:
                    raise SystemExit(f"interp {name}: launch failed")
                torch.cuda.synchronize()
                if not torch.allclose(out, want, rtol=1e-5, atol=1e-5):
                    raise AssertionError(f"interp {name} B={b} N={n} S={s}: disagrees")
                line.append(f"{name} {device_ms(run):.4f}")
            print(f"interp B={b} N={n} S={s} D={d} k={k} lanes {plan[5]}: device ms "
                  + ", ".join(line), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k1_k4_probe: no CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    probe_fps(dev)
    probe_interp(dev)


if __name__ == "__main__":
    main()
