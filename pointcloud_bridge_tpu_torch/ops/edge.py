"""The neighbour reduction of DGCNN's restructured EdgeConv (the JAX
package's models/dgcnn.py:117-140, which its TPU runs as one XLA fusion).

``edge_reduce(y, idx, moments)``: for y [B, N, F] float32 and idx
[B, S, k] int32 (clamped to N - 1 as ``index_points`` clamps), the max and
the min over each row's k neighbours and, with ``moments``, their mean and
mean square -> (mx, mn) or (mx, mn, s1, s2), each [B, S, F]. A CPU tensor
takes the plain version (``index_points`` and reductions), a CUDA tensor
the kernel K7 (csrc/edge_reduce.cu), which never builds the [B, S, k, F]
gathered tensor. Both fold each sum from 0.0 over the slots in order and
scale it by ``inv_k`` = float32(1 / k), so they give the same bits.

Its gradient is :class:`EdgeReduce`'s backward: a tie of the max (or of the
min) splits the cotangent evenly, as JAX's ``reduce_max`` VJP and torch's
``amax`` backward do; the mean sends g / k to every slot and the mean
square 2 y g / k. On the card that is K7b (csrc/edge_reduce_bwd.cu), the
per-edge gradients, folded onto the points by the group backward K3b in a
fixed order, so the same bits every call. While exported the forward is the
custom op ``pcb::edge_reduce``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import numpy as np
import torch

from . import _kernels
from .core import index_points
from .grouping import group_backward_cuda, group_backward_plain

# the integers of a launch, in the order pcb_edge_reduce and
# pcb_edge_reduce_backward read them from their `plan`
EDGE_PLAN = ("b", "n", "s", "k", "f", "vec", "moments", "inv_k_bits")


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
    versions on a CPU tensor."""

    @staticmethod
    def forward(ctx, y, idx, moments):
        run = edge_reduce_cuda if y.is_cuda else edge_reduce_plain
        outs = run(y, idx, moments)
        ctx.save_for_backward(y, idx, outs[0], outs[1])
        ctx.moments = moments
        return outs

    @staticmethod
    def backward(ctx, *grads):
        y, idx, mx, mn = ctx.saved_tensors
        run = edge_reduce_backward_cuda if y.is_cuda else edge_reduce_backward_plain
        return run(y, idx, mx, mn, *grads[:4 if ctx.moments else 2]), None, None


def edge_reduce_plain(y: torch.Tensor, idx: torch.Tensor, moments: bool = False) -> tuple:
    """Plain PyTorch: the gathered [B, S, k, F], amax and amin over the
    slots, and the sums as K7 folds them (from 0.0, slot by slot, then
    times ``inv_k``)."""
    yg = index_points(y, idx)
    mx, mn = yg.amax(dim=2), yg.amin(dim=2)
    if not moments:
        return mx, mn
    s1 = torch.zeros_like(mx)
    s2 = torch.zeros_like(mx)
    for j in range(yg.shape[2]):
        v = yg[:, :, j]
        s1 = s1 + v
        s2 = s2 + v * v
    scale = inv_k(yg.shape[2])
    return mx, mn, s1 * scale, s2 * scale


def edge_grads_plain(y, idx, mx, mn, g_mx, g_mn, g_s1=None, g_s2=None) -> torch.Tensor:
    """The per-edge gradients [B, S, k, F] that K7b writes, in its order of
    operations (csrc/edge_reduce_bwd.cu). Folded by
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


def edge_reduce_backward_plain(y, idx, mx, mn, g_mx, g_mn, g_s1=None, g_s2=None) -> torch.Tensor:
    """The gradient on y [B, N, F]: the per-edge gradients summed onto the
    points by ``scatter_add_``."""
    e = edge_grads_plain(y, idx, mx, mn, g_mx, g_mn, g_s1, g_s2)
    return group_backward_plain(e, idx, y.shape[1], 0, y.shape[2])


def edge_vec(f: int, *tensors: torch.Tensor) -> int:
    """Floats a lane of K7 and K7b: the fewest of 1, 2 and 4 whose 32 lanes
    cover F (2 at F = 64), else 4; each where F is a multiple of it and
    every tensor's data is aligned to it, else the next smaller."""
    want = next((v for v in (1, 2, 4) if 32 * v >= f), 4)
    for v in (4, 2, 1):
        if v <= want and f % v == 0 and all(t.data_ptr() % (4 * v) == 0 for t in tensors):
            return v
    return 1


@functools.lru_cache(maxsize=1024)
def _edge_plan(b: int, n: int, s: int, k: int, f: int, vec: int, moments: bool):
    """pcb_edge_reduce's plan (EDGE_PLAN), checked and laid out once a shape."""
    if k < 1 or f < 1 or n < 1 or b * s >= 2**31 or vec not in (1, 2, 4) or f % vec:
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


def edge_reduce_cuda(y: torch.Tensor, idx: torch.Tensor, moments: bool = False) -> tuple:
    """K7 wrapper (csrc/edge_reduce.cu pcb_edge_reduce): one launch."""
    b, n, s, k, f = _check_edge_args(y, idx)
    outs = tuple(torch.empty(b, s, f, dtype=torch.float32, device=y.device)
                 for _ in range(4 if moments else 2))
    plan = _edge_plan(b, n, s, k, f, edge_vec(f, y, *outs), moments)
    if b * s == 0:
        return outs
    ptrs = [t.data_ptr() for t in outs] + [None] * (4 - len(outs))
    _kernels.EDGE_REDUCE.launch(y.data_ptr(), idx.data_ptr(), *ptrs, plan,
                                *_kernels.stream_args(y))
    return outs


def edge_reduce_backward_cuda(y, idx, mx, mn, g_mx, g_mn, g_s1=None, g_s2=None) -> torch.Tensor:
    """K7b wrapper (csrc/edge_reduce_bwd.cu pcb_edge_reduce_backward): the
    per-edge gradients [B, S, k, F] in one launch, then the group backward
    K3b (one launch) sums them onto the points -> [B, N, F]."""
    b, n, s, k, f = _check_edge_args(y, idx)
    moments = g_s1 is not None
    rows = [t.contiguous() for t in (mx, mn, g_mx, g_mn) + ((g_s1, g_s2) if moments else ())]
    for name, t in zip(("mx", "mn", "g_mx", "g_mn", "g_s1", "g_s2"), rows):
        _kernels.check_tensor(name, t, torch.float32, 3)
        if t.shape != (b, s, f):
            raise ValueError(f"edge reduce backward: {name} {tuple(t.shape)}, expected "
                             f"{(b, s, f)}")
    e = torch.empty(b, s, k, f, dtype=torch.float32, device=y.device)
    plan = _edge_plan(b, n, s, k, f, edge_vec(f, y, e, *rows), moments)
    if e.numel() == 0:
        return torch.zeros_like(y)
    ptrs = [t.data_ptr() for t in rows] + [None] * (6 - len(rows))
    _kernels.EDGE_REDUCE_BWD.launch(y.data_ptr(), idx.data_ptr(), *ptrs, e.data_ptr(), plan,
                                    *_kernels.stream_args(y))
    return group_backward_cuda(e, idx, n, 0, f)


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
