"""The neighbour reduction of DGCNN's restructured EdgeConv (the JAX
package's models/dgcnn.py:117-140, which its TPU runs as one XLA fusion).

``edge_reduce(y, idx, moments)``: for y [B, N, F] float32 and idx
[B, S, k] int32 (clamped to N - 1 as ``index_points`` clamps), the max and
the min over each row's k neighbours and, with ``moments``, their mean and
mean square -> (mx, mn) or (mx, mn, s1, s2), each [B, S, F]. A CPU tensor
takes the plain version (``index_points`` and reductions), a CUDA tensor
the kernel K7 (csrc/edge_reduce.cu), which never builds the [B, S, k, F]
gathered tensor. Both fold each sum from 0.0 over the slots in order and
scale it by ``inv_k`` = float32(1 / k), so they give the same bits. Where
a gradient will be asked for, both also count the ties of the max and the
min (``tie_counts_plain``), which the backward divides by.

Its gradient is :class:`EdgeReduce`'s backward: a tie of the max (or of the
min) splits the cotangent evenly, as JAX's ``reduce_max`` VJP and torch's
``amax`` backward do; the mean sends g / k to every slot and the mean
square 2 y g / k. On the card that is K7b (csrc/edge_reduce_bwd.cu): the
slots sorted by point, then each point's slots' terms added in ascending
slot order by the thread that owns the point, so the same bits every call,
with no per-edge tensor. While exported the forward is the custom op
``pcb::edge_reduce``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import numpy as np
import torch

from . import _kernels
from .core import index_points
from .grouping import GROUP_BWD_MAX_N, MAX_SMEM, fast_divisor, group_backward_plain

# the integers of a launch, in the order pcb_edge_reduce (K7) and
# pcb_edge_reduce_backward (K7b) read them from their `plan`
EDGE_PLAN = ("b", "n", "s", "k", "f", "vec", "moments", "inv_k_bits")
EDGE_BWD_PLAN = ("b", "n", "s", "k", "f", "moments", "split", "staged", "k_mul", "k_shift",
                 "inv_k_bits")
# K7b's fold: a block a channel pair, a thread a point; staged, it holds
# a record of 48 bytes a row in shared memory (mx, mn and two moment terms a
# channel, the two cotangents over their ties of both)
EDGE_FOLD_RECORD = 48
# slots a batch element that one block of K7b's counting sort takes
EDGE_SORT_SLICE = 5120
# the tie counts are packed into 16 bits each
TIES_MAX_K = 2**16 - 1
_INT_LIMIT = 2**31


def inv_k(k: int) -> float:
    """float32(1 / k), correctly rounded, as a Python float (exact)."""
    return float(np.float32(1.0) / np.float32(k))


def edge_reduce(y: torch.Tensor, idx: torch.Tensor, moments: bool = False) -> tuple:
    """(mx, mn) or, with ``moments``, (mx, mn, s1, s2) of y's rows over the
    neighbours idx (see the module docstring)."""
    if torch.compiler.is_compiling():
        return tuple(EDGE_REDUCE_OP(y, idx, moments))
    return EdgeReduce.apply(y, idx, moments)


class EdgeReduce(torch.autograd.Function):
    """edge_reduce with its backward: K7 and K7b on a CUDA tensor, the plain
    versions on a CPU tensor. Where y needs a gradient the forward also
    counts the ties, which it keeps for the backward."""

    @staticmethod
    def forward(ctx, y, idx, moments):
        ties = ctx.needs_input_grad[0]
        run = edge_reduce_cuda if y.is_cuda else edge_reduce_plain
        outs = run(y, idx, moments, ties)
        if ties:
            ctx.save_for_backward(y, idx, outs[0], outs[1], outs[-1])
            outs = outs[:-1]
        ctx.moments = moments
        return outs

    @staticmethod
    def backward(ctx, *grads):
        y, idx, mx, mn, ties = ctx.saved_tensors
        run = edge_reduce_backward_cuda if y.is_cuda else edge_reduce_backward_plain
        return run(y, idx, mx, mn, *grads[:4 if ctx.moments else 2], ties=ties), None, None


def _ties(yg: torch.Tensor, mx: torch.Tensor, mn: torch.Tensor) -> torch.Tensor:
    hits = (yg == mx.unsqueeze(2)).sum(dim=2) | (yg == mn.unsqueeze(2)).sum(dim=2) << 16
    return hits.to(torch.int32)


def tie_counts_plain(y: torch.Tensor, idx: torch.Tensor, mx: torch.Tensor,
                     mn: torch.Tensor) -> torch.Tensor:
    """K7's ties [B, S, F] int32: the slots of a row whose value equals its
    max, or'd with those equal to its min shifted left by 16 (the counts
    ``edge_grads_plain`` divides by; K7 counts them as the slots go by)."""
    return _ties(index_points(y, idx), mx, mn)


def edge_reduce_plain(y: torch.Tensor, idx: torch.Tensor, moments: bool = False,
                      ties: bool = False) -> tuple:
    """Plain PyTorch: the gathered [B, S, k, F], amax and amin over the
    slots, and the sums as K7 folds them (from 0.0, slot by slot, then
    times ``inv_k``); with ``ties`` the tie counts appended."""
    yg = index_points(y, idx)
    mx, mn = yg.amax(dim=2), yg.amin(dim=2)
    outs = (mx, mn)
    if moments:
        s1 = torch.zeros_like(mx)
        s2 = torch.zeros_like(mx)
        for j in range(yg.shape[2]):
            v = yg[:, :, j]
            s1 = s1 + v
            s2 = s2 + v * v
        scale = inv_k(yg.shape[2])
        outs += (s1 * scale, s2 * scale)
    return outs + (_ties(yg, mx, mn),) if ties else outs


def edge_grads_plain(y, idx, mx, mn, g_mx, g_mn, g_s1=None, g_s2=None) -> torch.Tensor:
    """The per-edge gradients [B, S, k, F], in K7b's order of operations
    (csrc/edge_reduce_bwd.cu), the ties counted here. Folded by
    ``grouping.group_backward_order`` they give the kernel's bits."""
    yg = index_points(y, idx)
    hit_mx, hit_mn = yg == mx.unsqueeze(2), yg == mn.unsqueeze(2)
    gx = g_mx / hit_mx.sum(dim=2).to(y.dtype)
    gn = g_mn / hit_mn.sum(dim=2).to(y.dtype)
    e = torch.where(hit_mx, gx.unsqueeze(2), 0.0) + torch.where(hit_mn, gn.unsqueeze(2), 0.0)
    if g_s1 is not None:
        scale = inv_k(idx.shape[-1])
        e = e + (g_s1 * scale).unsqueeze(2)
        e = e + yg * ((g_s2 * scale) * 2.0).unsqueeze(2)
    return e


def edge_reduce_backward_plain(y, idx, mx, mn, g_mx, g_mn, g_s1=None, g_s2=None,
                               ties=None) -> torch.Tensor:
    """The gradient on y [B, N, F]: the per-edge gradients summed onto the
    points by ``scatter_add_`` (``ties`` is not read: the plain version
    counts them again)."""
    e = edge_grads_plain(y, idx, mx, mn, g_mx, g_mn, g_s1, g_s2)
    return group_backward_plain(e, idx, y.shape[1], 0, y.shape[2])


# ------------------------------------------------------------ the launch


def edge_vec(f: int, *tensors: torch.Tensor) -> int:
    """Floats a lane of K7: the fewest of 1, 2 and 4 whose 32 lanes cover F
    (2 at F = 64), else 4; each where F is a multiple of it and every
    tensor's data is aligned to it, else the next smaller."""
    want = next((v for v in (1, 2, 4) if 32 * v >= f), 4)
    for v in (4, 2, 1):
        if v <= want and f % v == 0 and all(t.data_ptr() % (4 * v) == 0 for t in tensors):
            return v
    return 1


@functools.lru_cache(maxsize=1024)
def _edge_plan(b: int, n: int, s: int, k: int, f: int, vec: int, moments: bool):
    """pcb_edge_reduce's plan (EDGE_PLAN), checked and laid out once a shape."""
    if k < 1 or f < 1 or n < 1 or b * s >= _INT_LIMIT or vec not in (1, 2, 4) or f % vec:
        raise ValueError(f"edge reduce kernel takes k, F, N >= 1, B * S < 2^31 and F a multiple "
                         f"of vec, got B={b}, N={n}, S={s}, k={k}, F={f}, vec={vec}")
    bits = int(np.float32(inv_k(k)).view(np.int32))
    return (ctypes.c_int * len(EDGE_PLAN))(b, n, s, k, f, vec, int(moments), bits)


def _check_edge_args(y: torch.Tensor, idx: torch.Tensor) -> Tuple[int, int, int, int, int]:
    _kernels.check_tensor("y", y, torch.float32, 3)
    _kernels.check_tensor("idx", idx, torch.int32, 3)
    b, n, f = y.shape
    _, s, k = idx.shape
    if idx.shape[0] != b or idx.device != y.device:
        raise ValueError(f"edge reduce: y {tuple(y.shape)} vs idx {tuple(idx.shape)}")
    return b, n, s, k, f


def edge_reduce_cuda(y: torch.Tensor, idx: torch.Tensor, moments: bool = False,
                     ties: bool = False) -> tuple:
    """K7 wrapper (csrc/edge_reduce.cu pcb_edge_reduce): one launch; with
    ``ties`` the tie counts [B, S, F] int32 appended."""
    b, n, s, k, f = _check_edge_args(y, idx)
    if ties and k > TIES_MAX_K:
        raise ValueError(f"edge reduce kernel counts ties in 16 bits: k={k} > {TIES_MAX_K}")
    outs = tuple(torch.empty(b, s, f, dtype=torch.float32, device=y.device)
                 for _ in range(4 if moments else 2))
    if ties:
        outs += (torch.empty(b, s, f, dtype=torch.int32, device=y.device),)
    plan = _edge_plan(b, n, s, k, f, edge_vec(f, y, *outs), moments)
    if b * s == 0:
        return outs
    ptrs = [t.data_ptr() for t in outs[:4 if moments else 2]]
    ptrs += [None] * (4 - len(ptrs)) + [outs[-1].data_ptr() if ties else None]
    _kernels.EDGE_REDUCE.launch(y.data_ptr(), idx.data_ptr(), *ptrs, plan,
                                *_kernels.stream_args(y))
    return outs


def edge_fold_staged(s: int) -> bool:
    """K7b's fold route: staged where S records of 48 bytes fit a block's
    shared memory (S <= 4,842), else read from device memory at each slot."""
    return s * EDGE_FOLD_RECORD <= MAX_SMEM


def edge_sort_split(b: int, s: int, k: int, sms: int) -> int:
    """Blocks a batch element of K7b's counting sort: a slice of
    EDGE_SORT_SLICE slots or more each, and no more blocks over the batch
    than two an SM (the scan reads split histograms of N a batch element)."""
    return max(1, min(-(-(s * k) // EDGE_SORT_SLICE), -(-2 * sms // b)))


def edge_bwd_work(b: int, n: int, s: int, k: int, split: int) -> int:
    """Ints of scratch pcb_edge_reduce_backward takes: the bucket ends
    [B, N], the count blocks' histograms [B, split, N], the buckets and
    their rows in order, [B, S * k] each."""
    return b * (n + split * n + 2 * s * k)


def _check_edge_bwd(b: int, n: int, s: int, k: int, f: int) -> None:
    if not 1 <= b <= 65535 or not 1 <= n <= GROUP_BWD_MAX_N or b * s * k >= _INT_LIMIT:
        raise ValueError(f"edge reduce backward kernel takes 1 <= B <= 65535, 1 <= N <= "
                         f"{GROUP_BWD_MAX_N} and B * S * k < 2^31, got B={b}, N={n}, S={s}, "
                         f"k={k}")
    if k < 1 or k > TIES_MAX_K or f < 1 or f > 65535:
        raise ValueError(f"edge reduce backward kernel takes 1 <= k <= {TIES_MAX_K} and "
                         f"1 <= F <= 65535, got k={k}, F={f}")


@functools.lru_cache(maxsize=1024)
def _edge_bwd_plan(b: int, n: int, s: int, k: int, f: int, moments: bool, split: int):
    """pcb_edge_reduce_backward's plan (EDGE_BWD_PLAN), checked and laid out
    once a shape: the fold's route by S (``edge_fold_staged``)."""
    _check_edge_bwd(b, n, s, k, f)
    if not 1 <= split <= 65535:
        raise ValueError(f"edge reduce backward: split {split} outside [1, 65535]")
    bits = int(np.float32(inv_k(k)).view(np.int32))
    return (ctypes.c_int * len(EDGE_BWD_PLAN))(b, n, s, k, f, int(moments), split,
                                               int(edge_fold_staged(s)), *fast_divisor(k), bits)


@functools.lru_cache(maxsize=1024)
def _edge_bwd_launch(b: int, n: int, s: int, k: int, f: int, moments: bool,
                     device: int) -> tuple:
    """(plan, ints of scratch) of a K7b launch on ``device``, worked out once
    a shape; the shape is checked before the device is read."""
    _check_edge_bwd(b, n, s, k, f)
    split = edge_sort_split(b, s, k, _kernels.sm_count(device))
    return _edge_bwd_plan(b, n, s, k, f, moments, split), edge_bwd_work(b, n, s, k, split)


def edge_reduce_backward_cuda(y, idx, mx, mn, g_mx, g_mn, g_s1=None, g_s2=None,
                              ties=None) -> torch.Tensor:
    """K7b wrapper (csrc/edge_reduce_bwd.cu pcb_edge_reduce_backward): the
    gradient on y [B, N, F] in one call (three launches, five where the
    sort splits), over K7's ``ties``; scratch: the sort's ints
    (``edge_bwd_work``)."""
    b, n, s, k, f = _check_edge_args(y, idx)
    moments = g_s1 is not None
    rows = [t.contiguous() for t in (mx, mn, g_mx, g_mn) + ((g_s1, g_s2) if moments else ())]
    for name, t in zip(("mx", "mn", "g_mx", "g_mn", "g_s1", "g_s2"), rows):
        _kernels.check_tensor(name, t, torch.float32, 3)
        if t.shape != (b, s, f):
            raise ValueError(f"edge reduce backward: {name} {tuple(t.shape)}, expected "
                             f"{(b, s, f)}")
    if b * s * n * f == 0:
        return torch.zeros_like(y)
    plan, work_ints = _edge_bwd_launch(b, n, s, k, f, moments, y.get_device())
    if ties is None:
        raise ValueError("edge reduce backward: K7b divides by K7's ties "
                         "(edge_reduce_cuda(..., ties=True))")
    _kernels.check_tensor("ties", ties, torch.int32, 3)
    if ties.shape != (b, s, f):
        raise ValueError(f"edge reduce backward: ties {tuple(ties.shape)}, expected {(b, s, f)}")
    out = torch.empty(b, n, f, dtype=torch.float32, device=y.device)
    work = torch.empty(work_ints, dtype=torch.int32, device=y.device)
    ptrs = [t.data_ptr() for t in rows] + [None] * (6 - len(rows))
    _kernels.EDGE_REDUCE_BWD.launch(y.data_ptr(), idx.data_ptr(), ptrs[0], ptrs[1],
                                    ties.data_ptr(), *ptrs[2:], out.data_ptr(), work.data_ptr(),
                                    plan, *_kernels.stream_args(y))
    return out


def _edge_reduce_op_plain(y: torch.Tensor, idx: torch.Tensor,
                          moments: bool) -> List[torch.Tensor]:
    return list(edge_reduce_plain(y, idx, moments))


def _edge_reduce_op_cuda(y, idx, moments):
    return list(edge_reduce_cuda(y.contiguous(), idx.contiguous(), moments))


def _edge_reduce_fake(y, idx, moments):
    shape = (*idx.shape[:2], y.shape[2])
    return [y.new_empty(shape) for _ in range(4 if moments else 2)]


# pcb::edge_reduce, K7 as a custom op (ops/_kernels.py custom_op)
EDGE_REDUCE_OP = _kernels.custom_op("edge_reduce", _edge_reduce_op_plain, _edge_reduce_op_cuda,
                                    _edge_reduce_fake)
