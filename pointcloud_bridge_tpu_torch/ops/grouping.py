"""Ball query, k-NN and grouping (counterpart of
pointcloud_bridge_tpu/ops/grouping.py).

Only the exact semantics are ported: there is no ``approx`` and no
``recall_target``. A CPU tensor goes to the plain PyTorch version, a CUDA
tensor to the kernel (csrc/ballq.cu, csrc/knn.cu, csrc/group.cu); both give
the same result bit for bit. ``group_points`` is the autograd Function
:class:`GroupPoints` on both devices; its backward is a scatter-add, the
kernel csrc/group_bwd.cu on the card. k-NN indices carry no gradient.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from . import _kernels
from .core import index_points, pairwise_sq_dist
from .sampling import farthest_point_sample


def radius_sq(radius: float) -> float:
    """radius**2 as the JAX package compares it: squared in double, then
    rounded to float32 (ops/grouping.py:137, ballq.py:132). The float32
    value compares the same against float32 distances at any precision."""
    return float(np.float32(float(radius) * float(radius)))


def query_ball_point(
    radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor
) -> torch.Tensor:
    """Fixed-radius neighbourhoods (ops/grouping.py:104-161).

    xyz [B, N, 3], new_xyz [B, S, 3] float32 -> [B, S, nsample] int32: the
    first nsample in-radius indices in ascending order, misses padded with
    the first hit, and N in every slot of an empty ball.
    """
    for name, t in (("xyz", xyz), ("new_xyz", new_xyz)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if xyz.device.type == "cpu":
        return ball_query_plain(radius, nsample, xyz, new_xyz)
    return ball_query_cuda(radius, nsample, xyz, new_xyz)


def ball_query_plain(
    radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch ball query: a top-k over keys N - j of the hits (0 for a
    miss), so the largest keys are the lowest hit indices."""
    n = xyz.shape[1]
    within = pairwise_sq_dist(new_xyz, xyz) <= radius_sq(radius)
    ar = torch.arange(n, device=xyz.device)
    key = torch.where(within, n - ar, 0)
    top = key.topk(min(nsample, n), dim=-1, largest=True, sorted=True).values
    if top.shape[-1] < nsample:  # more slots than points: pad with misses
        top = torch.nn.functional.pad(top, (0, nsample - top.shape[-1]))
    idx = n - top  # a miss (key 0) becomes N
    return torch.where(top > 0, idx, idx[..., :1]).to(torch.int32)


def ball_query_cuda(
    radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor
) -> torch.Tensor:
    """Ball-query kernel wrapper: one launch."""
    _kernels.check_tensor("xyz", xyz, torch.float32, 3)
    _kernels.check_tensor("new_xyz", new_xyz, torch.float32, 3)
    b, n, c = xyz.shape
    s = new_xyz.shape[1]
    if c != 3 or new_xyz.shape[0] != b or new_xyz.shape[2] != 3:
        raise ValueError(
            f"ball query: bad shapes {tuple(xyz.shape)}, {tuple(new_xyz.shape)}"
        )
    out = torch.empty((b, s, nsample), dtype=torch.int32, device=xyz.device)
    if out.numel() == 0:
        return out
    _kernels.BALL_QUERY.launch(
        xyz.data_ptr(), new_xyz.data_ptr(), out.data_ptr(), b, n, s, nsample,
        radius_sq(radius), *_kernels.stream_args(xyz),
    )
    return out


# the kernel keeps the k best of a query in two registers of each lane
KNN_MAX_K = 64


def knn_with_distance(
    xyz: torch.Tensor, query: Optional[torch.Tensor] = None, k: int = 20
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k nearest points of every query by squared distance, the query
    itself included when it is one of the points (ops/grouping.py:191-209).

    xyz [B, N, 3], query [B, S, 3] float32 (default xyz) -> (d2 [B, S, k]
    float32, idx [B, S, k] int32), nearest first, equal distances to the
    lower index. Distances are in the direct form of ``pairwise_sq_dist``.
    """
    if query is None:
        query = xyz
    for name, t in (("xyz", xyz), ("query", query)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if not 1 <= k <= xyz.shape[1]:
        raise ValueError(f"knn: expected 1 <= k <= N, got k={k}, N={xyz.shape[1]}")
    if xyz.device.type == "cpu":
        return knn_plain(xyz, query, k)
    return knn_cuda(xyz.contiguous(), query.contiguous(), k)


def knn(xyz: torch.Tensor, query: Optional[torch.Tensor] = None, k: int = 20) -> torch.Tensor:
    """``knn_with_distance`` without the distances (ops/grouping.py:164-188)."""
    return knn_with_distance(xyz, query, k)[1]


def knn_set(xyz: torch.Tensor, query: Optional[torch.Tensor] = None, k: int = 16) -> torch.Tensor:
    """k nearest neighbours for consumers that ignore their order
    (ops/grouping.py:212-251). The exact sorted list is such a set, and it
    is what the JAX op returns wherever its selection kernel is off."""
    return knn(xyz, query, k)


def knn_plain(
    xyz: torch.Tensor, query: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch k-NN: all pairwise distances and a stable sort, which
    keeps the lower index ahead on equal distances (``torch.topk`` promises
    no tie order)."""
    d2, order = pairwise_sq_dist(query, xyz).sort(dim=-1, stable=True)
    return d2[..., :k].contiguous(), order[..., :k].to(torch.int32)


def knn_cuda(
    xyz: torch.Tensor, query: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """k-NN kernel wrapper: one launch (csrc/knn.cu) -> (d2, idx)."""
    _kernels.check_tensor("xyz", xyz, torch.float32, 3)
    _kernels.check_tensor("query", query, torch.float32, 3)
    b, n, c = xyz.shape
    s = query.shape[1]
    if c != 3 or query.shape[0] != b or query.shape[2] != 3:
        raise ValueError(f"knn: bad shapes {tuple(xyz.shape)}, {tuple(query.shape)}")
    if not 1 <= k <= min(KNN_MAX_K, n):
        raise ValueError(f"knn kernel takes 1 <= k <= min({KNN_MAX_K}, N), got k={k}, N={n}")
    if b > 65535:
        raise ValueError(f"knn kernel takes B <= 65535, got {b}")
    idx = torch.empty((b, s, k), dtype=torch.int32, device=xyz.device)
    d2 = torch.empty((b, s, k), dtype=torch.float32, device=xyz.device)
    if idx.numel() == 0:
        return d2, idx
    _kernels.KNN.launch(
        xyz.data_ptr(), query.data_ptr(), idx.data_ptr(), d2.data_ptr(), b, n, s, k,
        *_kernels.stream_args(xyz),
    )
    return d2, idx


def group_points(
    xyz: torch.Tensor,
    new_xyz: torch.Tensor,
    idx: torch.Tensor,
    features: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Centre-relative neighbourhoods (ops/grouping.py:280-300).

    xyz [B, N, 3], new_xyz [B, S, 3], idx [B, S, K] int32 (clamped to N-1),
    features [B, N, C] or None -> [B, S, K, 3] or [B, S, K, 3 + C].
    Differentiable in xyz, new_xyz and features.
    """
    return GroupPoints.apply(xyz, new_xyz, idx, features)


class GroupPoints(torch.autograd.Function):
    """group_points with its backward: the feature and xyz gradients are a
    scatter-add of the grouped gradient over the clamped indices (repeats
    add up), and dnew_xyz = -sum over the K slots of the xyz channels."""

    @staticmethod
    def forward(ctx, xyz, new_xyz, idx, features):
        ctx.save_for_backward(idx)
        ctx.n = xyz.shape[1]
        if xyz.device.type == "cpu":
            return group_plain(xyz, new_xyz, idx, features)
        return group_cuda(xyz, new_xyz, idx, features)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        need_xyz, need_new, _, need_feats = ctx.needs_input_grad
        width = g.shape[-1]
        # one scatter covers the contiguous channel range that is needed
        c0 = 0 if need_xyz else 3
        c1 = width if need_feats else 3
        dxyz = dnew = dfeats = None
        if c0 < c1:
            if g.device.type == "cpu":
                d = group_backward_plain(g, idx, ctx.n, c0, c1)
            else:
                d = group_backward_cuda(g.contiguous(), idx, ctx.n, c0, c1)
            if need_xyz:
                dxyz = d[..., :3]
            if need_feats:
                dfeats = d[..., 3 - c0:]
        if need_new:
            dnew = -g[..., :3].sum(dim=2)
        return dxyz, dnew, None, dfeats


def group_plain(xyz, new_xyz, idx, features=None) -> torch.Tensor:
    grouped = index_points(xyz, idx) - new_xyz.unsqueeze(2)
    if features is None:
        return grouped
    return torch.cat([grouped, index_points(features, idx)], dim=-1)


# 2^31: every element offset inside the group kernels is a 32-bit int, and a
# fast divisor holds for dividends below it
_INT_LIMIT = 2**31
# csrc/group.cu stages a warp's tile of rows in shared memory where the tile
# fits _STAGED_FLOATS floats (the warp's share of 48 KB)
_STAGED_FLOATS = 3072


def group_lanes(units: int) -> int:
    """Lanes that own one row of ``units`` (a width in channels, or in
    4-channel units where a lane takes four): 4, 8, 16 or 32."""
    return 4 if units <= 4 else 8 if units <= 8 else 16 if units <= 16 else 32


@functools.lru_cache(maxsize=None)
def fast_divisor(d: int) -> Tuple[int, int]:
    """(mul, shift) with n // d == (n * mul >> 32) >> shift for 0 <= n < 2^31
    (csrc/common.cuh FastDiv): mul = ceil(2^(31 + l) / d), shift = l - 1,
    l = ceil(log2 d); (0, 0) for d = 1, which the kernel reads as n."""
    if not 1 <= d < _INT_LIMIT:
        raise ValueError(f"fast divisor: expected 1 <= d < 2^31, got {d}")
    if d == 1:
        return 0, 0
    l = (d - 1).bit_length()
    return -(-(1 << (31 + l)) // d), l - 1


@functools.lru_cache(maxsize=None)
def group_launch(width: int) -> Tuple[int, int, bool]:
    """(lanes a row, rows in flight a lane group, staged) of csrc/group.cu
    for rows of ``width`` floats: a warp's tile is (32 / lanes) * rows rows,
    one index a lane; 8 rows where that tile fits shared memory, else 4
    staged, else 4 stored 4 bytes a lane."""
    lanes = group_lanes(width)
    for rows in (8, 4):
        tile = 32 // lanes * rows
        if tile <= 32 and (tile * width + 6) // 4 * 4 <= _STAGED_FLOATS:
            return lanes, rows, True
    return lanes, 4, False


# the integers of a launch, in the order pcb_group (csrc/group.cu) and
# pcb_group_backward (csrc/group_bwd.cu) read them from their `plan`
GROUP_PLAN = ("b", "n", "s", "k", "c", "lanes", "rows", "staged", "k_mul", "k_shift")
GROUP_BWD_PLAN = ("b", "n", "s", "k", "width", "c0", "c1", "lanes", "vec")


@functools.lru_cache(maxsize=1024)
def _group_plan(b: int, n: int, s: int, k: int, c: int, staged: Optional[bool] = None):
    """pcb_group's plan for B, N, S, K, C (GROUP_PLAN), checked and laid out
    once a shape. ``staged`` False forces 4-byte stores and 4 rows a group;
    True raises where a tile does not fit shared memory."""
    width = 3 + c
    if b * s * k * width >= 2**30 or n * width >= _INT_LIMIT or b > 65535:
        raise ValueError(f"group kernel takes < 2^30 output elements, N * (3 + C) < 2^31 "
                         f"and B <= 65535, got [{b}, {s}, {k}] x {width} over N={n}")
    lanes, rows, fits = group_launch(width)
    if staged is not None and staged != fits:
        if staged:
            raise ValueError(f"group kernel: a tile of width {width} does not fit shared memory")
        rows, fits = 4, False
    return (ctypes.c_uint * len(GROUP_PLAN))(b, n, s, k, c, lanes, rows, fits,
                                             *fast_divisor(max(k, 1)))


def group_cuda(xyz, new_xyz, idx, features=None, staged=None) -> torch.Tensor:
    """Group kernel wrapper: one launch writes all 3 + C channels. ``staged``
    False forces 4-byte stores where the kernel would stage its tiles (a
    comparison on the card); by default it stages wherever a tile fits."""
    _kernels.check_tensor("xyz", xyz, torch.float32, 3)
    _kernels.check_tensor("new_xyz", new_xyz, torch.float32, 3)
    _kernels.check_tensor("idx", idx, torch.int32, 3)
    b, n, three = xyz.shape
    _, s, k = idx.shape
    c = 0
    if features is not None:
        _kernels.check_tensor("features", features, torch.float32, 3)
        c = features.shape[2]
        if features.shape[:2] != (b, n):
            raise ValueError(f"group: features {tuple(features.shape)} vs xyz {tuple(xyz.shape)}")
    if three != 3 or new_xyz.shape != (b, s, 3) or idx.shape[0] != b:
        raise ValueError(
            f"group: bad shapes {tuple(xyz.shape)}, {tuple(new_xyz.shape)}, {tuple(idx.shape)}"
        )
    plan = _group_plan(b, n, s, k, c, staged)
    # the sizes as separate arguments: torch parses them faster than a tuple
    out = torch.empty(b, s, k, 3 + c, dtype=torch.float32, device=xyz.device)
    if out.numel() == 0:
        return out
    _kernels.GROUP.launch(
        xyz.data_ptr(), new_xyz.data_ptr(), idx.data_ptr(),
        features.data_ptr() if c else None, out.data_ptr(), plan, *_kernels.stream_args(xyz),
    )
    return out
    lanes, rows, fits = group_launch(width)
    if staged is not None and staged != fits:
        if staged:
            raise ValueError(f"group kernel: a tile of width {width} does not fit shared memory")
        rows, fits = 4, False
    _kernels.GROUP.launch(
        xyz.data_ptr(), new_xyz.data_ptr(), idx.data_ptr(),
        features.data_ptr() if c else None, out.data_ptr(), b, n, s, k, c, lanes, rows,
        fits, *fast_divisor(k), *_kernels.stream_args(xyz),
    )
    return out


def group_backward_plain(
    g: torch.Tensor, idx: torch.Tensor, n: int, c0: int, c1: int
) -> torch.Tensor:
    """Plain scatter-add: g [B, S, K, W], idx [B, S, K] -> [B, N, c1 - c0],
    the sum of g[..., c0:c1] over the slots whose clamped index is each
    point. Channels 0-2 of g are xyz, 3.. the features."""
    b, s, k, _ = g.shape
    flat = idx.reshape(b, s * k, 1).clamp(0, n - 1).long()
    src = g[..., c0:c1].reshape(b, s * k, c1 - c0)
    out = torch.zeros((b, n, c1 - c0), dtype=g.dtype, device=g.device)
    return out.scatter_add_(1, flat.expand_as(src), src)


@functools.lru_cache(maxsize=1024)
def _group_backward_plan(b: int, n: int, s: int, k: int, width: int, c0: int, c1: int):
    """pcb_group_backward's plan (GROUP_BWD_PLAN), checked and laid out once
    a shape: four channels a lane where c1 - c0 is a multiple of 4."""
    if not 0 <= c0 < c1 <= width or n < 1:
        raise ValueError(f"group backward: bad channels [{c0}, {c1}) of {width}, N={n}")
    if b > 65535:
        raise ValueError(f"group backward kernel takes B <= 65535, got {b}")
    vec = 4 if (c1 - c0) % 4 == 0 else 1
    return (ctypes.c_int * len(GROUP_BWD_PLAN))(b, n, s, k, width, c0, c1,
                                                group_lanes((c1 - c0) // vec), vec)


def group_backward_cuda(
    g: torch.Tensor, idx: torch.Tensor, n: int, c0: int, c1: int
) -> torch.Tensor:
    """Group-backward kernel wrapper: one launch (csrc/group_bwd.cu)."""
    _kernels.check_tensor("g", g, torch.float32, 4)
    _kernels.check_tensor("idx", idx, torch.int32, 3)
    b, s, k, width = g.shape
    if idx.shape != (b, s, k):
        raise ValueError(f"group backward: g {tuple(g.shape)} vs idx {tuple(idx.shape)}")
    plan = _group_backward_plan(b, n, s, k, width, c0, c1)
    out = torch.empty(b, n, c1 - c0, dtype=torch.float32, device=g.device)
    if b * s * k == 0:
        return out.zero_()
    _kernels.GROUP_BWD.launch(g.data_ptr(), idx.data_ptr(), out.data_ptr(), plan,
                              *_kernels.stream_args(g))
    return out


def sample_and_group(
    npoint: int,
    radius: float,
    nsample: int,
    xyz: torch.Tensor,
    features: Optional[torch.Tensor] = None,
    fps_start_idx=0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """FPS + ball query + grouping (ops/grouping.py:303-319).

    Returns (new_xyz [B,S,3], new_points [B,S,K,3(+C)], fps_idx [B,S])."""
    fps_idx = farthest_point_sample(xyz, npoint, fps_start_idx)
    new_xyz = index_points(xyz, fps_idx)
    idx = query_ball_point(radius, nsample, xyz, new_xyz)
    return new_xyz, group_points(xyz, new_xyz, idx, features), fps_idx
