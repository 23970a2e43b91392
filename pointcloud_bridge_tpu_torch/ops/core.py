"""Core dense ops: batched gather and pairwise squared distances.

Counterpart of pointcloud_bridge_tpu/ops/core.py. The 3-channel grouped
gather that the JAX package runs as a Pallas kernel is fused into
``group_points`` here (ops/grouping.py, kernel csrc/group.cu).
"""

from __future__ import annotations

import torch


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched gather: out[b, ...] = points[b, clamp(idx[b, ...], 0, N-1)].

    points [B, N, C], idx integer [B, ...] -> [B, *idx.shape[1:], C]. The
    clamp is the reference's (ops/core.py:83-105): a ball-query miss is
    index N and reads point N-1.

    On the card, float32 points that need a gradient go through
    :class:`IndexPoints`, whose backward is the group-backward kernel
    (csrc/group_bwd.cu): each point's gradient a sum in a fixed order, so
    the same bits every call (``torch.gather``'s own backward adds with
    float atomics in an order that varies). Elsewhere it is ``torch.gather``.
    """
    if (points.is_cuda and points.requires_grad and torch.is_grad_enabled()
            and points.dtype == torch.float32):
        return IndexPoints.apply(points, idx)
    return _gather(points, idx)


def _gather(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    b, n, c = points.shape
    flat = idx.reshape(b, -1).clamp(0, n - 1).long()
    out = torch.gather(points, 1, flat.unsqueeze(-1).expand(-1, -1, c))
    return out.reshape(*idx.shape, c)


class IndexPoints(torch.autograd.Function):
    """index_points with the group backward as its gradient: idx is viewed
    as [B, S, K] (K its last axis, 1 for a 2-D idx) and the gradient
    [B, S, K, C] summed onto the points with c0 = 0, c1 = C."""

    @staticmethod
    def forward(ctx, points, idx):
        b = points.shape[0]
        k = idx.shape[-1] if idx.dim() > 2 else 1
        ctx.save_for_backward(idx.reshape(b, -1, k).to(torch.int32).contiguous())
        ctx.n = points.shape[1]
        return _gather(points, idx)

    @staticmethod
    def backward(ctx, g):
        from .grouping import group_backward_cuda

        (idx,) = ctx.saved_tensors
        b, s, k = idx.shape
        c = g.shape[-1]
        return group_backward_cuda(g.reshape(b, s, k, c).contiguous(), idx, ctx.n, 0, c), None


def pairwise_sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B, M, C] x [B, N, C] -> [B, M, N] squared distances in the direct
    form the kernels use, a left fold over the channels: d0*d0, then
    + dc*dc for c = 1 .. C-1, each step its own elementwise op so that the
    rounding is the same on every device. For C = 3 that is
    (dx*dx + dy*dy) + dz*dz. (A ``.sum(-1)`` over the channels leaves the
    order to the backend.) The fold adds into its accumulator in place, so
    a step holds three [B, M, N] buffers whatever C is."""
    def diff(c: int) -> torch.Tensor:
        return a[..., c].unsqueeze(2) - b[..., c].unsqueeze(1)

    d = diff(0)
    acc = d * d
    for c in range(1, a.shape[-1]):
        d = diff(c)
        acc += d * d
    return acc


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distance in the reference's expanded form
    -2*src@dst^T + |src|^2 + |dst|^2 (ops/core.py:58-80), kept for API
    parity. The ops of the slice use ``pairwise_sq_dist`` instead: the
    expansion cancels and can move a point across a radius or a tie.

    src [B, N, C], dst [B, M, C] -> [B, N, M] of src's type, computed in
    float32 as the JAX function computes it (its products and sums of
    squares in float32 for any input type).
    """
    a, b = src.float(), dst.float()
    cross = torch.einsum("bnc,bmc->bnm", a, b)
    s2 = (a * a).sum(-1).unsqueeze(2)
    d2 = (b * b).sum(-1).unsqueeze(1)
    return (-2.0 * cross + s2 + d2).to(src.dtype)
