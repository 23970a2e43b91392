#!/usr/bin/env python3
"""K7 and K7b beside their other designs on the card.

    python3 chip_smoke.py --edge-split     (the first K7b split, the buckets)
    python3 chip_smoke.py --edge probes    (K7b's parts, splits, variants)
    python3 chip_smoke.py --edge ties      (K7b's ties: online in K7, or a row pass)

Nothing here is on the port's main path. ``k7_first.cu`` and
``k7b_first.cu`` beside this file are csrc/edge_reduce.cu and
csrc/edge_reduce_bwd.cu as their first design had them (a warp a row; the backward
writes per-edge gradients [B, S, k, F] that K3b, csrc/group_bwd.cu, folds),
their entry points renamed; ``k7_staged.cu`` is the staged K7, measured
and left out (y's channel slice in shared memory); ``k7b_rows.cu`` the row
pass that would count K7b's ties in the backward instead of K7 in the
forward, measured and left out. They build into build/probes/k7_first.so,
only where chip_smoke.py is asked for them (--dgcnn, --edge, --edge-split). chip_smoke.py times the first design in
braces beside the port's K7 and K7b (phase 3f), runs DGCNN's steps on it
beside the port's (phase 45) and measures the peak memory of one EdgeConv
forward and backward on each design.

``split_first_backward`` splits one call of the first K7b into its parts, as
device ms from a CUDA graph of 20 calls: the per-edge pass, K3b's counting
sort (csrc/group_bwd.cu with its fold launch cut out by a textual edit) and
K3b's fold (K3b's whole launch less the sort). ``longest_buckets`` prints
the in-degrees of graphs (the bucket lengths K3b's fold and K7b's rank).
``split_backward`` splits the port's K7b (sort, rank, fold; the call cut
after each part) and times it at several sort splits; ``compare_variants``
times the staged K7 and K7b with one part taken out or changed
(K7_VARIANTS, K7B_VARIANTS), beside K7. ``compare_tie_designs`` times K7
counting the ties online against K7 without them and the row pass, beside
K7b and the first design.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import subprocess
from pathlib import Path

import numpy as np
import torch

from pointcloud_bridge_tpu_torch.ops import _kernels, edge, grouping
from pointcloud_bridge_tpu_torch.probes.k1_k4_probe import device_ms

HERE = Path(__file__).resolve().parent
OUT = _kernels.BUILD_DIR.parent / "probes"
P, I = ctypes.c_void_p, ctypes.c_int
# The first design's plan of both kernels: b, n, s, k, f, vec, moments, inv_k's bits
FIRST_PLAN = ("b", "n", "s", "k", "f", "vec", "moments", "inv_k_bits")
# K7b (csrc/edge_reduce_bwd.cu) cut after its sort, and after its rank:
# (part, the line it returns before, the return)
K7B_PARTS = (("sort", "  const dim3 rank_grid(", "  return (int)cudaGetLastError();\n"),
             ("sort and rank", "  const Rows r{", "  return (int)cudaGetLastError();\n"))
# K3b with the launch of its fold cut out: the counting sort alone
SORT_ONLY = ("const dim3 grid((unsigned)((n + kFoldWarps - 1) / kFoldWarps)",
             "return (int)cudaGetLastError();\n  const dim3 grid((unsigned)((n + kFoldWarps - 1) "
             "/ kFoldWarps)")


def _nvcc(sources, name: str) -> Path:
    OUT.mkdir(parents=True, exist_ok=True)
    so = OUT / f"{name}.so"
    cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-I", str(_kernels.CSRC), "-o", str(so),
           *map(str, sources)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{res.stdout}\n{res.stderr}")
    return so


def _sort_only_source() -> Path:
    text = (_kernels.CSRC / "group_bwd.cu").read_text()
    if SORT_ONLY[0] not in text:
        raise RuntimeError("group_bwd.cu: the text to edit is gone")
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "group_bwd_sort_only.cu"
    src.write_text(text.replace(SORT_ONLY[0], SORT_ONLY[1], 1))
    return src


@functools.lru_cache(maxsize=None)
def k7b_parts() -> dict:
    """part -> the library of csrc/edge_reduce_bwd.cu cut after that part
    (a return before the next launch), one nvcc each, side by side."""
    text = (_kernels.CSRC / "edge_reduce_bwd.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    sources = {}
    for i, (part, line, cut) in enumerate(K7B_PARTS):
        if line not in text:
            raise RuntimeError("edge_reduce_bwd.cu: the text to edit is gone")
        sources[part] = OUT / f"k7b_part_{i}.cu"
        sources[part].write_text(text.replace(line, cut + line, 1))
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        built = {part: pool.submit(_nvcc, (src,), src.stem) for part, src in sources.items()}
        libs = {part: ctypes.CDLL(str(so.result())) for part, so in built.items()}
    for lib in libs.values():
        lib.pcb_edge_reduce_backward.argtypes = list(_kernels.EDGE_REDUCE_BWD.argtypes)
        lib.pcb_edge_reduce_backward.restype = I
    return libs


@functools.lru_cache(maxsize=None)
def start_build() -> concurrent.futures.Future:
    """Build both libraries in a thread of their own (one nvcc each, side by
    side with the package's own build): -> a future of (first, sort_only)
    ctypes libraries."""
    pool = concurrent.futures.ThreadPoolExecutor(2)
    first = pool.submit(_nvcc, (HERE / "k7_first.cu", HERE / "k7b_first.cu",
                                HERE / "k7_staged.cu", HERE / "k7b_rows.cu"), "k7_first")
    sort = pool.submit(lambda: _nvcc((_sort_only_source(),), "group_bwd_sort_only"))

    def load():
        lib = ctypes.CDLL(str(first.result()))
        lib.pcb_edge_reduce_first.argtypes = [P] * 7 + [I, P]
        lib.pcb_edge_reduce_backward_first.argtypes = [P] * 10 + [I, P]
        lib.pcb_edge_reduce_staged.argtypes = [P] * 8 + [I, P]
        lib.pcb_edge_tie_rows.argtypes = [P] * 6 + [I, P]
        sort_lib = ctypes.CDLL(str(sort.result()))
        sort_lib.pcb_group_backward.argtypes = [P] * 5 + [I, P]
        for fn in (lib.pcb_edge_reduce_first, lib.pcb_edge_reduce_backward_first,
                   lib.pcb_edge_reduce_staged, lib.pcb_edge_tie_rows,
                   sort_lib.pcb_group_backward):
            fn.restype = I
        pool.shutdown(wait=False)
        return lib, sort_lib

    return concurrent.futures.ThreadPoolExecutor(1).submit(load)


def libraries():
    return start_build().result()


@functools.lru_cache(maxsize=256)
def first_plan(b: int, n: int, s: int, k: int, f: int, vec: int, moments: bool):
    bits = int(np.float32(edge.inv_k(k)).view(np.int32))
    return (ctypes.c_int * len(FIRST_PLAN))(b, n, s, k, f, vec, int(moments), bits)


def _check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")


def edge_reduce_first(y: torch.Tensor, idx: torch.Tensor, moments: bool = False,
                      ties: bool = False) -> tuple:
    """The first K7: (mx, mn) or (mx, mn, s1, s2); with ``ties`` a None
    appended where the port's K7 appends its tie counts (the first design's backward
    counted them again), so that the port's autograd Function runs on it."""
    b, n, s, k, f = edge._check_edge_args(y, idx)
    outs = tuple(torch.empty(b, s, f, device=y.device) for _ in range(4 if moments else 2))
    plan = first_plan(b, n, s, k, f, edge.edge_vec(f, y, *outs), moments)
    ptrs = [t.data_ptr() for t in outs] + [None] * (4 - len(outs))
    _check(libraries()[0].pcb_edge_reduce_first(y.data_ptr(), idx.data_ptr(), *ptrs, plan,
                                                 *_kernels.stream_args(y)), "K7 (first design)")
    if ties:
        outs += (None,)
    return outs


# the staged K7 (k7_staged.cu): a block of 1024 threads holds a slice of 8
# (or 4) channels of all N points of y, a lane a channel
STAGED_SLICES = (8, 4)
STAGED_THREADS = 1024


def staged_slice(n: int) -> int:
    """Channels a staged block holds: 8 where 8 channels of N points fit a
    block's shared memory (N <= 7,264), else 4 (N <= 14,528), else 0."""
    return next((c for c in STAGED_SLICES if n * c * 4 <= grouping.MAX_SMEM), 0)


def staged_rows_a_block(b: int, s: int, f: int, n: int, slice_: int, sms: int) -> int:
    """Rows a staged block folds: the rows split over as many blocks as the
    card holds at once beside the B * slices of the grid."""
    pairs = b * -(-f // slice_)
    an_sm = max(1, min(grouping.MAX_SMEM // (n * slice_ * 4), 2048 // STAGED_THREADS))
    splits = max(1, min(-(-s // (STAGED_THREADS // slice_)), sms * an_sm // pairs))
    return -(-s // splits)


def edge_reduce_staged(y: torch.Tensor, idx: torch.Tensor, moments: bool = False,
                       ties: bool = False) -> tuple:
    """K7's outputs from the staged route (k7_staged.cu), one launch."""
    b, n, s, k, f = edge._check_edge_args(y, idx)
    slice_ = staged_slice(n)
    if not slice_:
        raise ValueError(f"staged K7: N={n} does not fit a block's shared memory")
    outs = tuple(torch.empty(b, s, f, device=y.device) for _ in range(4 if moments else 2))
    if ties:
        outs += (torch.empty(b, s, f, dtype=torch.int32, device=y.device),)
    vec = next(v for v in (4, 2, 1) if f % v == 0 and y.data_ptr() % (4 * v) == 0)
    rows = staged_rows_a_block(b, s, f, n, slice_, _kernels.sm_count(y.get_device()))
    bits = int(np.float32(edge.inv_k(k)).view(np.int32))
    plan = (ctypes.c_int * 10)(b, n, s, k, f, vec, int(moments), slice_, rows, bits)
    ptrs = [t.data_ptr() for t in outs[:4 if moments else 2]]
    ptrs += [None] * (4 - len(ptrs)) + [outs[-1].data_ptr() if ties else None]
    _check(libraries()[0].pcb_edge_reduce_staged(y.data_ptr(), idx.data_ptr(), *ptrs, plan,
                                                  *_kernels.stream_args(y)), "staged K7")
    return outs


def edge_tie_rows(y: torch.Tensor, idx: torch.Tensor, mx: torch.Tensor,
                  mn: torch.Tensor) -> torch.Tensor:
    """K7b's ties from a row pass of their own (k7b_rows.cu), one launch:
    the counts K7 otherwise keeps online, [B, S, F] int32."""
    b, n, s, k, f = edge._check_edge_args(y, idx)
    ties = torch.empty(b, s, f, dtype=torch.int32, device=y.device)
    plan = edge._edge_plan(b, n, s, k, f, edge.edge_vec(f, y, mx, mn, ties), False)
    _check(libraries()[0].pcb_edge_tie_rows(y.data_ptr(), idx.data_ptr(), mx.data_ptr(),
                                             mn.data_ptr(), ties.data_ptr(), plan,
                                             *_kernels.stream_args(y)), "K7b's row pass")
    return ties


def compare_tie_designs(dev, cases, inputs) -> None:
    """The two ways to give K7b its ties, at each (B, k, F, launches, path)
    of ``cases`` (train mode, the moments), on ``inputs(b, k, f)``: K7
    counting them online (the port) against K7 without them and a row pass
    of K7b's own (k7b_rows.cu), and, beside both, K7b and the first design
    (K7 without ties, the first K7b: the parent's backward). Device ms a
    call in turns (online, row pass, first, first, row pass, online), the
    ties of both designs bit for bit against each other and against
    tie_counts_plain; then the sums over each path's launches."""
    rng = np.random.default_rng(10)
    sums = {}
    for b, k, f, launches, path in cases:
        y, idx = inputs(b, k, f)
        s = idx.shape[1]
        *outs, ties = edge.edge_reduce_cuda(y, idx, True, True)
        rows = edge_tie_rows(y, idx, outs[0], outs[1])
        torch.cuda.synchronize()
        if not torch.equal(rows, ties) or not torch.equal(
                rows, edge.tie_counts_plain(y, idx, outs[0], outs[1])):
            raise AssertionError(f"row pass B={b} k={k} F={f}: other ties")
        cots = [torch.from_numpy(rng.normal(size=(b, s, f)).astype(np.float32)).to(dev)
                for _ in outs]
        args = (y, idx, outs[0], outs[1], *cots)
        runs = {
            "online": lambda: edge.edge_reduce_cuda(y, idx, True, True),
            "K7 alone": lambda: edge.edge_reduce_cuda(y, idx, True, False),
            "row pass": lambda: edge_tie_rows(y, idx, outs[0], outs[1]),
            "K7b": lambda: edge.edge_reduce_backward_cuda(*args, ties=ties),
            "first K7b": lambda: edge_reduce_backward_first(*args),
        }
        order = ("online", "K7 alone", "row pass", "K7b", "first K7b")
        turns = {name: [] for name in order}
        for name in order + order[::-1]:
            turns[name].append(device_ms(runs[name]))
        total = sums.setdefault(path, {name: [0.0, 0.0] for name in order} | {"launches": 0})
        total["launches"] += launches
        for name in order:
            for i, t in enumerate(turns[name]):
                total[name][i] += launches * t
        print(f"ties B={b} N=S={y.shape[1]} k={k} F={f}, device ms a call (two turns): "
              + ", ".join(f"{name} {t[0]:.4f}, {t[1]:.4f}" for name, t in turns.items())
              + "; the row pass's ties equal K7's and tie_counts_plain's", flush=True)
    for path, t in sums.items():
        def both(*names, t=t):
            return ", ".join(f"{sum(t[n][i] for n in names):.4f}" for i in range(2))

        print(f"ties over {path} ({t['launches']} launches of each), device ms (two turns): "
              f"K7 counting online {both('online')}, K7 alone {both('K7 alone')} + row pass "
              f"{both('row pass')} = {both('K7 alone', 'row pass')}; with K7b "
              f"{both('K7b')}: online {both('online', 'K7b')}, row pass "
              f"{both('K7 alone', 'row pass', 'K7b')}; the first design (K7 alone, the "
              f"first K7b {both('first K7b')}) {both('K7 alone', 'first K7b')}", flush=True)


def edge_grads_first(y, idx, mx, mn, g_mx, g_mn, g_s1=None, g_s2=None) -> torch.Tensor:
    """The first design's per-edge pass: e [B, S, k, F] in one launch."""
    b, n, s, k, f = edge._check_edge_args(y, idx)
    rows = [t.contiguous() for t in (mx, mn, g_mx, g_mn) + ((g_s1, g_s2) if g_s1 is not None
                                                             else ())]
    e = torch.empty(b, s, k, f, device=y.device)
    plan = first_plan(b, n, s, k, f, edge.edge_vec(f, y, e, *rows), g_s1 is not None)
    ptrs = [t.data_ptr() for t in rows] + [None] * (6 - len(rows))
    _check(libraries()[0].pcb_edge_reduce_backward_first(
        y.data_ptr(), idx.data_ptr(), *ptrs, e.data_ptr(), plan, *_kernels.stream_args(y)),
        "K7b (first design)")
    return e


def edge_reduce_backward_first(y, idx, mx, mn, g_mx, g_mn, g_s1=None, g_s2=None,
                               ties=None) -> torch.Tensor:
    """The first K7b as its wrapper ran it: the per-edge pass, then K3b
    (``ties`` is not read: the first design counted the ties again)."""
    e = edge_grads_first(y, idx, mx, mn, g_mx, g_mn, g_s1, g_s2)
    return grouping.group_backward_cuda(e, idx, y.shape[1], 0, y.shape[2])


def use_first_design(module) -> dict:
    """Point ``module`` (ops.edge) at the first design's wrappers -> the names it had,
    for ``restore``."""
    saved = {name: getattr(module, name) for name in ("edge_reduce_cuda",
                                                     "edge_reduce_backward_cuda")}
    module.edge_reduce_cuda = edge_reduce_first
    module.edge_reduce_backward_cuda = edge_reduce_backward_first
    return saved


def restore(module, saved: dict) -> None:
    for name, fn in saved.items():
        setattr(module, name, fn)


def in_degrees(idx: torch.Tensor, n: int) -> torch.Tensor:
    """The slots that point at each point, [B, N] (the clamp of index_points)."""
    flat = idx.reshape(idx.shape[0], -1).clamp(0, n - 1).long()
    deg = torch.zeros(idx.shape[0], n, dtype=torch.long, device=idx.device)
    return deg.scatter_add_(1, flat, torch.ones_like(flat))


def bucket_line(label: str, idx: torch.Tensor, n: int) -> str:
    """The longest bucket, the mean of the ten longest, the points with more
    than 32 slots and the shuffles of K3b's ranking, sum over the points of
    ceil(L / 32)^2 * 32, against k * N * 32 for buckets of k each."""
    deg = in_degrees(idx, n)
    top = deg.flatten().topk(min(10, deg.numel())).values.double()
    rank = ((deg + 31) // 32).pow(2).sum().item() * 32
    flat = idx.shape[0] * n * 32 * (-(-idx.shape[-1] // 32)) ** 2
    return (f"{label}: longest bucket {int(deg.max())}, ten longest {top.mean().item():.1f}, "
            f"{int((deg > 32).sum())} of {deg.numel()} points past 32 slots, ranking "
            f"{rank / flat:.2f}x its work at buckets of k")


def split_first_backward(dev, cases, inputs) -> None:
    """Step 0: the first K7b at each (B, k, F) of ``cases`` (train mode, the
    moments), on ``inputs(b, k, f)`` -> (y, idx): device ms of the per-edge
    pass, K3b's sort and K3b's fold, and the longest bucket."""
    _, sort_lib = libraries()
    rng = np.random.default_rng(7)
    for b, k, f in cases:
        y, idx = inputs(b, k, f)
        n, s = y.shape[1], idx.shape[1]
        outs = edge.edge_reduce_plain(y, idx, True)
        cots = [torch.from_numpy(rng.normal(size=(b, s, f)).astype(np.float32)).to(dev)
                for _ in outs]
        args = (y, idx, outs[0], outs[1], *cots)
        e = edge_grads_first(*args)
        plan, work_ints = grouping._group_backward_launch(b, n, s, k, f, 0, f, dev.index or 0)
        work = torch.empty(work_ints, dtype=torch.int32, device=dev)
        out = torch.empty(b, n, f, device=dev)
        want = grouping.group_backward_order(e, idx, n, 0, f)

        def whole():
            _kernels.GROUP_BWD.launch(e.data_ptr(), idx.data_ptr(), out.data_ptr(),
                                      work.data_ptr(), plan, *_kernels.stream_args(e))

        def sort():
            _check(sort_lib.pcb_group_backward(e.data_ptr(), idx.data_ptr(), out.data_ptr(),
                                               work.data_ptr(), plan, *_kernels.stream_args(e)),
                   "K3b sort")

        whole()
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f"K3b B={b} k={k} F={f}: not its fold order")
        t_edge = device_ms(lambda: edge_grads_first(*args))
        t_sort, t_whole = device_ms(sort), device_ms(whole)
        t_call = device_ms(lambda: edge_reduce_backward_first(*args))
        print(f"K7b (first design) B={b} N=S={n} k={k} F={f}: device ms a call {t_call:.4f}: "
              f"per-edge pass {t_edge:.4f}, K3b sort {t_sort:.4f} (split {plan[8]}), K3b fold "
              f"{t_whole - t_sort:.4f} (K3b {t_whole:.4f}); e {e.numel() * 4 / 1e6:.1f} MB; "
              + bucket_line("graph", idx, n), flush=True)
        del e, work, out


def longest_buckets(graphs) -> None:
    """``graphs``: (label, features [B, N, C], k) -> each one's k-NN graph
    over its own features (K5 at C = 3, K5c otherwise) and its buckets."""
    for label, x, k in graphs:
        idx = grouping.knn(x, k=k)
        print(bucket_line(label, idx, x.shape[1]), flush=True)


def split_backward(dev, cases, inputs, splits=(1, 2, 4, 8, 16)) -> None:
    """The port's K7b at each (B, k, F) of ``cases`` (train mode), device ms
    of the whole call and of its parts (the sort, the rank, the fold: the
    call cut after each, differences), then the whole call at each sort
    split of ``splits`` beside the wrapper's pick; every run's output
    against the wrapper's, bit for bit."""
    libs = k7b_parts()
    rng = np.random.default_rng(8)
    for b, k, f in cases:
        y, idx = inputs(b, k, f)
        n, s = y.shape[1], idx.shape[1]
        *outs, ties = edge.edge_reduce_cuda(y, idx, True, True)
        cots = [torch.from_numpy(rng.normal(size=(b, s, f)).astype(np.float32)).to(dev)
                for _ in outs]
        want = edge.edge_reduce_backward_cuda(y, idx, outs[0], outs[1], *cots, ties=ties)
        plan, _ = edge._edge_bwd_launch(b, n, s, k, f, True, dev.index or 0)
        out = torch.empty_like(y)

        def call(fn, split):
            p = edge._edge_bwd_plan(b, n, s, k, f, True, split)
            work = torch.empty(edge.edge_bwd_work(b, n, s, k, split), dtype=torch.int32,
                               device=dev)
            ptrs = [t.data_ptr() for t in (y, idx, outs[0], outs[1], ties, *cots, out, work)]
            return lambda work=work: _check(fn(*ptrs, p, *_kernels.stream_args(y)), "K7b")

        whole = call(_kernels.EDGE_REDUCE_BWD.fn, plan[6])
        times = {"whole": device_ms(whole)}
        for part, lib in libs.items():
            times[part] = device_ms(call(lib.pcb_edge_reduce_backward, plan[6]))
        by_split = {}
        for split in sorted(set(splits) | {plan[6]}):
            run = call(_kernels.EDGE_REDUCE_BWD.fn, split)
            run()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"K7b at split {split}: other bits")
            by_split[split] = device_ms(run)
        print(f"K7b B={b} N=S={n} k={k} F={f} (fold staged {edge.edge_fold_staged(s)}): "
              f"device ms a call {times['whole']:.4f}: sort {times['sort']:.4f} (split "
              f"{plan[6]}), rank {times['sort and rank'] - times['sort']:.4f}, fold "
              f"{times['whole'] - times['sort and rank']:.4f}; by split "
              + ", ".join(f"{k_}: {v:.4f}" for k_, v in by_split.items()), flush=True)


# Textual edits of csrc/edge_reduce.cu (K7) and csrc/edge_reduce_bwd.cu
# (K7b) that take one part of the staged kernels out, to see where the time
# goes: (name, [(old, new), ...]); the outputs of an edited kernel are wrong
K7_VARIANTS = (  # of k7_staged.cu
    ("kernel", []),
    ("staging only", [("  cp_async_wait_all();\n  __syncthreads();\n\n  constexpr int kRows",
                       "  cp_async_wait_all();\n  __syncthreads();\n  if (n > 0) return;\n"
                       "  constexpr int kRows")]),
    ("no idx loads", [("clamp_index(__ldg(ir + j0 + sub), n) : 0;",
                       "(r * 131 + j0 + sub) % n : 0;")]),
    ("no shared reads", [("fold_value<kMoments, kTies>(ys[p * L + sub],",
                          "fold_value<kMoments, kTies>((float)p,")]),
)
K7B_VARIANTS = (  # of csrc/edge_reduce_bwd.cu
    ("kernel", []),
    ("staging only", [("  if (width <= 0) return;  // a cluster's block past F stages and leaves",
                       "  if (n > 0) return;")]),
    ("no row loads", [("next[u] = start + u < end ? __ldg(rw + start + u) : 0;",
                       "next[u] = (start + u) & 1023;"),
                      ("next[u] = q + kAhead + u < end ? __ldg(rw + q + kAhead + u) : 0;",
                       "next[u] = (q + kAhead + u) & 1023;")]),
    ("no record reads", [("for (int c = 0; c < 2; ++c) a[u][c] = src.template "
                          "a<kMoments>(ii[u], c);",
                          "for (int c = 0; c < 2; ++c) a[u][c] = make_float4(v[c], 1.0f, "
                          "(float)ii[u], 0.5f);")]),
    ("no hits", [("if (hx || hn) {", "if (hx && hn && v[c] != v[c]) {")]),
    ("clusters of 4", [("constexpr int kCluster = 2;", "constexpr int kCluster = 4;")]),
    ("no cluster", [("constexpr int kCluster = 2;", "constexpr int kCluster = 1;")]),
)


def _variants(source: Path, table: tuple, tag: str) -> dict:
    """name -> the library of that variant of ``source``, one nvcc each."""
    text = source.read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    sources = {}
    for i, (name, edits) in enumerate(table):
        variant = text
        for old, new in edits:
            if old not in variant:
                raise RuntimeError(f"{source} variant {name}: the text to edit is gone")
            variant = variant.replace(old, new)
        sources[name] = OUT / f"{tag}_{i}.cu"
        sources[name].write_text(variant)
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        built = {name: pool.submit(_nvcc, (src,), src.stem) for name, src in sources.items()}
        return {name: ctypes.CDLL(str(so.result())) for name, so in built.items()}


def compare_variants(dev, cases, inputs) -> None:
    """Device ms of K7 (train flavour: moments and ties) and K7b at each
    (B, k, F) of ``cases`` with one part of the staged kernels taken out
    (K7_VARIANTS, K7B_VARIANTS), the wrapper's plan, in one graph of 20."""
    k7 = _variants(HERE / "k7_staged.cu", K7_VARIANTS, "k7_variant")
    k7b = _variants(_kernels.CSRC / "edge_reduce_bwd.cu", K7B_VARIANTS, "k7b_variant")
    for lib in k7.values():
        lib.pcb_edge_reduce_staged.argtypes = list(_kernels.EDGE_REDUCE.argtypes)
    for lib in k7b.values():
        lib.pcb_edge_reduce_backward.argtypes = list(_kernels.EDGE_REDUCE_BWD.argtypes)
    rng = np.random.default_rng(9)
    for b, k, f in cases:
        y, idx = inputs(b, k, f)
        n, s = y.shape[1], idx.shape[1]
        *outs, ties = edge.edge_reduce_cuda(y, idx, True, True)
        cots = [torch.from_numpy(rng.normal(size=(b, s, f)).astype(np.float32)).to(dev)
                for _ in outs]
        slice_ = staged_slice(n)
        rows = staged_rows_a_block(b, s, f, n, slice_, _kernels.sm_count(dev.index or 0))
        bits = int(np.float32(edge.inv_k(k)).view(np.int32))
        vec = next(v for v in (4, 2, 1) if f % v == 0 and y.data_ptr() % (4 * v) == 0)
        plan = (ctypes.c_int * 10)(b, n, s, k, f, vec, 1, slice_, rows, bits)
        fwd = [t.data_ptr() for t in (y, idx, *outs, ties)]
        kplan = edge._edge_plan(b, n, s, k, f, edge.edge_vec(f, y, *outs, ties), True)
        k7_ms = device_ms(lambda: _kernels.EDGE_REDUCE.launch(*fwd, kplan,
                                                               *_kernels.stream_args(y)))
        bplan, work_ints = edge._edge_bwd_launch(b, n, s, k, f, True, dev.index or 0)
        work = torch.empty(work_ints, dtype=torch.int32, device=dev)
        out = torch.empty_like(y)
        bwd = [t.data_ptr() for t in (y, idx, outs[0], outs[1], ties, *cots, out, work)]
        line = []
        for name, lib in k7.items():
            def run(fn=lib.pcb_edge_reduce_staged, name=name):
                _check(fn(*fwd, plan, *_kernels.stream_args(y)), name)

            line.append(f"{name} {device_ms(run):.4f}")
        print(f"staged K7 variants B={b} N=S={n} k={k} F={f} (moments, ties; slice {slice_}, "
              f"{rows} rows a block), device ms: " + ", ".join(line)
              + f"; K7 (csrc/edge_reduce.cu) {k7_ms:.4f}", flush=True)
        line = []
        for name, lib in k7b.items():
            def run(fn=lib.pcb_edge_reduce_backward, name=name):
                _check(fn(*bwd, bplan, *_kernels.stream_args(y)), name)

            line.append(f"{name} {device_ms(run):.4f}")
        print(f"K7b variants B={b} N=S={n} k={k} F={f}, device ms: " + ", ".join(line),
              flush=True)
