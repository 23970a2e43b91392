"""Ball query, k-NN and grouping (counterpart of
pointcloud_bridge_tpu/ops/grouping.py).

Only the exact semantics are ported: there is no ``approx`` and no
``recall_target``. A CPU tensor goes to the plain PyTorch version, a CUDA
tensor to the kernel (csrc/ballq.cu, csrc/knn.cu, csrc/group.cu); both give
the same result bit for bit. k-NN takes points of any width C: 3-D points
go to K5 (``knn_cuda``), any other width to K5c (``knn_c_cuda``); its
indices carry no gradient. ``group_points`` is the autograd Function
:class:`GroupPoints` on both devices; its backward is a scatter-add, the
kernel csrc/group_bwd.cu on the card. ``edge_conv_graph_feature`` is
DGCNN's (x_j - x_i, x_i) over a k-NN graph.
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
    return _query_ball_radii(((radius, nsample),), xyz, new_xyz)[0]


def _query_ball_radii(balls, xyz: torch.Tensor, new_xyz: torch.Tensor) -> list:
    """``query_ball_point`` at each (radius, nsample) of ``balls`` over the
    same points and centres, as a multi-scale set abstraction asks: on the
    card one scan computes each distance once for up to BALL_MAX_RADII
    radii, each output the same bits as its own one-radius query."""
    for name, t in (("xyz", xyz), ("new_xyz", new_xyz)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if xyz.device.type == "cpu":
        return [ball_query_plain(r, k, xyz, new_xyz) for r, k in balls]
    return ball_query_radii_cuda(tuple(balls), xyz.contiguous(), new_xyz.contiguous())


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


# points of a row that csrc/knn.cu and csrc/ballq.cu stage whole in shared
# memory (16 bytes a point: 128 KB); a longer row goes through a ring of two
# tiles of STAGE_TILE points
STAGE_ROW_MAX = 8192
STAGE_TILE = 4096
# radii that one ball-query launch answers (csrc/ballq.cu kMaxRadii)
BALL_MAX_RADII = 3
# warps an SM that a ball query keeps in flight with 4 queries a warp
_WARPS_AN_SM = 30
# the integers of a launch, in the order pcb_ball_query (csrc/ballq.cu) and
# pcb_knn (csrc/knn.cu) read them from their `plan`
BALL_PLAN = ("b", "n", "s", "warps", "queries", "tile", "radii",
             "k0", "r2_bits0", "k1", "r2_bits1", "k2", "r2_bits2")
KNN_PLAN = ("b", "n", "s", "k", "warps", "tile")


def stage_tile(n: int) -> int:
    """Points a staged tile for rows of N: the whole row up to
    STAGE_ROW_MAX, else a ring of two tiles of STAGE_TILE."""
    return n if n <= STAGE_ROW_MAX else STAGE_TILE


@functools.lru_cache(maxsize=None)
def neighbour_launch(b: int, s: int, sms: int, queries: int = 1) -> int:
    """Warps a block of K2 and K5 for B * S queries at ``queries`` a warp:
    the fewest of 4, 8, 16 and 32 that keep the blocks to about one an SM
    (measured fastest at every model level, PERF.md PR 9: a block stages its
    row once, so fewer and larger blocks copy less), 32 where there are
    more."""
    per_sm = -(-b * s // (queries * sms))
    return min(32, max(4, 1 << max(0, per_sm - 1).bit_length()))


def ball_queries_a_warp(b: int, s: int, sms: int) -> int:
    """4 queries a warp (one load of a point for the four) where that still
    leaves _WARPS_AN_SM warps an SM, else 1 (PERF.md PR 9)."""
    return 4 if b * s >= 4 * _WARPS_AN_SM * sms else 1


def _check_neighbour_launch(op: str, b: int, n: int, s: int, warps: int, tile: int) -> None:
    if n < 1 or n * 3 >= 2**31 or b > 65535 or b * s >= 2**31:
        raise ValueError(f"{op} kernel takes 1 <= N, N * 3 < 2^31, B <= 65535 and "
                         f"B * S < 2^31, got B={b}, N={n}, S={s}")
    if warps not in (4, 8, 16, 32) or not (tile >= n or 1 <= tile <= STAGE_ROW_MAX):
        raise ValueError(f"{op} kernel: no block of {warps} warps with tiles of {tile} "
                         f"points for N={n}")


def _r2_bits(radius: float) -> int:
    """radius_sq's float32 bits: the kernel compares the distances' uint32
    bits with them, the order of the floats for r2 >= 0."""
    r2 = np.float32(radius_sq(radius))
    if np.isnan(r2):
        raise ValueError(f"ball query kernel: radius {radius} is not a number")
    return int(r2.view(np.int32))


@functools.lru_cache(maxsize=1024)
def _ball_plan(b: int, n: int, s: int, balls: tuple, sms: int,
               warps: Optional[int] = None, queries: Optional[int] = None):
    """pcb_ball_query's plan (BALL_PLAN) for the (radius, K) of ``balls``
    (1 to BALL_MAX_RADII, every K >= 1), checked and laid out once a shape:
    ``ball_queries_a_warp`` and ``neighbour_launch`` (or ``queries`` and
    ``warps``) and ``stage_tile``."""
    if not 1 <= len(balls) <= BALL_MAX_RADII or any(k < 1 for _, k in balls):
        raise ValueError(f"ball query kernel takes 1 to {BALL_MAX_RADII} radii of K >= 1, "
                         f"got {balls}")
    queries = queries or ball_queries_a_warp(b, s, sms)
    if queries not in (1, 4):
        raise ValueError(f"ball query kernel takes 1 or 4 queries a warp, got {queries}")
    warps = warps or neighbour_launch(b, s, sms, queries)
    tile = stage_tile(n)
    _check_neighbour_launch("ball query", b, n, s, warps, tile)
    radii = [v for r, k in balls for v in (k, _r2_bits(r))]
    radii += [0] * (2 * BALL_MAX_RADII - len(radii))
    return (ctypes.c_int * len(BALL_PLAN))(b, n, s, warps, queries, tile, len(balls), *radii)


def ball_query_cuda(
    radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor
) -> torch.Tensor:
    """Ball-query kernel wrapper for one radius: one launch."""
    return ball_query_radii_cuda(((radius, nsample),), xyz, new_xyz)[0]


def ball_query_radii_cuda(balls, xyz: torch.Tensor, new_xyz: torch.Tensor) -> list:
    """Ball-query kernel wrapper (csrc/ballq.cu): the [B, S, K] indices of
    each (radius, K) of ``balls``, one launch for every BALL_MAX_RADII
    radii."""
    _kernels.check_tensor("xyz", xyz, torch.float32, 3)
    _kernels.check_tensor("new_xyz", new_xyz, torch.float32, 3)
    b, n, c = xyz.shape
    s = new_xyz.shape[1]
    if c != 3 or new_xyz.shape[0] != b or new_xyz.shape[2] != 3:
        raise ValueError(
            f"ball query: bad shapes {tuple(xyz.shape)}, {tuple(new_xyz.shape)}"
        )
    outs = [torch.empty(b, s, k, dtype=torch.int32, device=xyz.device) for _, k in balls]
    if b * s == 0:
        return outs
    stream = _kernels.stream_args(xyz)
    sms = _kernels.sm_count(stream[0])
    for part, at in _ball_launches(balls):
        plan = _ball_plan(b, n, s, part, sms)
        ptrs = [outs[i].data_ptr() for i in at]
        _kernels.BALL_QUERY.launch(xyz.data_ptr(), new_xyz.data_ptr(),
                                   *ptrs, *_NO_OUTPUT[len(ptrs):], plan, *stream)
    return outs


@functools.lru_cache(maxsize=256)
def _ball_launches(balls: tuple) -> tuple:
    """((radii, their positions in ``balls``), ...) of each launch: up to
    BALL_MAX_RADII radii a launch, none of K = 0 (an empty output)."""
    live = [i for i, (_, k) in enumerate(balls) if k > 0]
    return tuple((tuple(balls[i] for i in live[at:at + BALL_MAX_RADII]),
                  tuple(live[at:at + BALL_MAX_RADII]))
                 for at in range(0, len(live), BALL_MAX_RADII))


_NO_OUTPUT = (None,) * BALL_MAX_RADII


# the kernel keeps the k best of a query in two registers of each lane
KNN_MAX_K = 64


def knn_with_distance(
    xyz: torch.Tensor, query: Optional[torch.Tensor] = None, k: int = 20
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k nearest points of every query by squared distance, the query
    itself included when it is one of the points (ops/grouping.py:191-209).

    xyz [B, N, C], query [B, S, C] float32 (default xyz), any C >= 1 ->
    (d2 [B, S, k] float32, idx [B, S, k] int32), nearest first, equal
    distances to the lower index. Distances are in the direct form of
    ``pairwise_sq_dist``, over all C channels. Neither output carries a
    gradient: the inputs are taken detached.
    """
    if query is None:
        query = xyz
    for name, t in (("xyz", xyz), ("query", query)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if xyz.dim() != 3 or query.dim() != 3 or query.shape[0] != xyz.shape[0] \
            or query.shape[2] != xyz.shape[2] or xyz.shape[2] < 1:
        raise ValueError(f"knn: expected [B, N, C] and [B, S, C] with C >= 1, got "
                         f"{tuple(xyz.shape)} and {tuple(query.shape)}")
    if not 1 <= k <= xyz.shape[1]:
        raise ValueError(f"knn: expected 1 <= k <= N, got k={k}, N={xyz.shape[1]}")
    xyz, query = xyz.detach(), query.detach()
    if xyz.device.type == "cpu":
        return knn_plain(xyz, query, k)
    if xyz.shape[2] == 3:
        return knn_cuda(xyz.contiguous(), query.contiguous(), k)
    return knn_c_cuda(xyz.contiguous(), query.contiguous(), k)


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
    """Plain PyTorch k-NN over all C channels: all pairwise distances and a
    stable sort, which keeps the lower index ahead on equal distances
    (``torch.topk`` promises no tie order)."""
    d2, order = pairwise_sq_dist(query, xyz).sort(dim=-1, stable=True)
    return d2[..., :k].contiguous(), order[..., :k].to(torch.int32)


@functools.lru_cache(maxsize=1024)
def _knn_plan(b: int, n: int, s: int, k: int, sms: int, warps: Optional[int] = None,
              tile: Optional[int] = None):
    """pcb_knn's plan (KNN_PLAN), checked and laid out once a shape:
    ``neighbour_launch`` (or ``warps``) and ``stage_tile`` (or ``tile``, at
    most STAGE_ROW_MAX where it is not the whole row)."""
    if not 1 <= k <= min(KNN_MAX_K, n):
        raise ValueError(f"knn kernel takes 1 <= k <= min({KNN_MAX_K}, N), got k={k}, N={n}")
    warps = warps or neighbour_launch(b, s, sms)
    tile = tile or stage_tile(n)
    _check_neighbour_launch("knn", b, n, s, warps, tile)
    return (ctypes.c_int * len(KNN_PLAN))(b, n, s, k, warps, tile)


def knn_cuda(
    xyz: torch.Tensor, query: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5 wrapper, k-NN over 3-D points: one launch (csrc/knn.cu pcb_knn)
    -> (d2, idx)."""
    _kernels.check_tensor("xyz", xyz, torch.float32, 3)
    _kernels.check_tensor("query", query, torch.float32, 3)
    b, n, c = xyz.shape
    s = query.shape[1]
    if c != 3 or query.shape[0] != b or query.shape[2] != 3:
        raise ValueError(f"knn: bad shapes {tuple(xyz.shape)}, {tuple(query.shape)}")
    stream = _kernels.stream_args(xyz)
    plan = _knn_plan(b, n, s, k, _kernels.sm_count(stream[0]))
    idx = torch.empty(b, s, k, dtype=torch.int32, device=xyz.device)
    d2 = torch.empty(b, s, k, dtype=torch.float32, device=xyz.device)
    if idx.numel() == 0:
        return d2, idx
    _kernels.KNN.launch(xyz.data_ptr(), query.data_ptr(), idx.data_ptr(), d2.data_ptr(), plan,
                        *stream)
    return d2, idx


# csrc/knn.cu's constants that K5c's shared memory is laid out by: points a
# tile is padded to (kGroup), candidate slots a query (kBuf, 8 bytes a slot)
# and the most a block may opt into (kMaxSmem)
KNN_GROUP = 128
KNN_BUF = 64
MAX_SMEM = 232_448
# the integers of a K5c launch, in the order pcb_knn_c (csrc/knn.cu) reads them
KNN_C_PLAN = ("b", "n", "s", "k", "c", "warps", "queries", "tile", "vec")
# queries a warp that K5c is compiled for
KNN_C_QUERIES = (1, 2)


def knn_c_smem(c: int, tile: int, ring: int, warps: int, queries: int) -> int:
    """Shared bytes of a K5c block (csrc/knn.cu knn_c_smem): ``ring`` tiles
    of C channels, the warps' ``queries`` queries each and their candidate
    slots."""
    return (ring * c * -(-tile // KNN_GROUP) * KNN_GROUP * 4
            + -(-warps * queries * c * 4 // 16) * 16 + warps * queries * KNN_BUF * 8)


def knn_c_tile(n: int, c: int, warps: int, queries: int) -> int:
    """Points a staged tile of K5c: the whole row where it fits shared
    memory, else the most whole groups of KNN_GROUP points that let a ring
    of two fit (384 at C = 64, 32 warps and a query a warp; 256 at 32 warps
    of 2 queries); 0 where not even one group does."""
    if knn_c_smem(c, n, 1, warps, queries) <= MAX_SMEM:
        return n
    return (MAX_SMEM - knn_c_smem(c, 0, 0, warps, queries)) // (2 * c * 4 * KNN_GROUP) * KNN_GROUP


@functools.lru_cache(maxsize=None)
def knn_c_launch(b: int, s: int, sms: int) -> Tuple[int, int]:
    """(warps a block, queries a warp) of K5c for B * S queries: 2 queries a
    warp (one point load for the two) at the warps ``neighbour_launch``
    gives pairs of queries (about one block an SM, 32 warps where there are
    more) wherever every SM still gets a block of 4 warps (B * S >= 8 an
    SM); else a query a warp at the warps it gives single queries. The
    tile is then the most that fits (``knn_c_tile``: 256 points at C = 64,
    32 warps). chip_smoke.py --neighbours times the choices (PERF.md §6):
    at N = S = 4096, 32 x 2 is the fastest at B = 2, 4 and 16 and 16 x 2 at
    B = 1, each 21-34% under a warp a query."""
    if b * s >= 2 * 4 * sms:
        return neighbour_launch(b, s, sms, 2), 2
    return neighbour_launch(b, s, sms), 1


@functools.lru_cache(maxsize=1024)
def _knn_c_plan(b: int, n: int, s: int, k: int, c: int, sms: int, vec: bool,
                warps: Optional[int] = None, tile: Optional[int] = None,
                queries: Optional[int] = None):
    """pcb_knn_c's plan (KNN_C_PLAN), checked and laid out once a shape:
    ``knn_c_launch`` (or ``warps`` and ``queries``) and ``knn_c_tile`` (or
    ``tile``); ``vec`` stages four channels a copy (C a multiple of 4, rows
    on 16 bytes)."""
    if not 1 <= k <= min(KNN_MAX_K, n):
        raise ValueError(f"knn kernel takes 1 <= k <= min({KNN_MAX_K}, N), got k={k}, N={n}")
    if c < 1 or n * c >= 2**31 or b > 65535 or b * s >= 2**31:
        raise ValueError(f"knn kernel takes C >= 1, N * C < 2^31, B <= 65535 and "
                         f"B * S < 2^31, got B={b}, N={n}, S={s}, C={c}")
    if vec and c % 4:
        raise ValueError(f"knn kernel stages four channels a copy only where 4 divides C={c}")
    if warps is None or queries is None:
        warps_planned, queries_planned = knn_c_launch(b, s, sms)
        warps, queries = warps or warps_planned, queries or queries_planned
    if queries not in KNN_C_QUERIES or warps not in (4, 8, 16, 32):
        raise ValueError(f"knn kernel: no block of {warps} warps of {queries} queries "
                         f"(4, 8, 16 or 32 warps of {' or '.join(map(str, KNN_C_QUERIES))})")
    tile = tile or knn_c_tile(n, c, warps, queries)
    ring = 1 if tile >= n else 2
    if tile < 1 or knn_c_smem(c, tile, ring, warps, queries) > MAX_SMEM:
        raise ValueError(f"knn kernel: no block of {warps} warps of {queries} queries with "
                         f"tiles of {tile} points of C={c} channels fits {MAX_SMEM} bytes of "
                         "shared memory")
    return (ctypes.c_int * len(KNN_C_PLAN))(b, n, s, k, c, warps, queries, tile, int(vec))


def knn_c_cuda(
    xyz: torch.Tensor, query: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5c wrapper, k-NN over points of any width C >= 1: one launch
    (csrc/knn.cu pcb_knn_c) -> (d2, idx)."""
    _kernels.check_tensor("xyz", xyz, torch.float32, 3)
    _kernels.check_tensor("query", query, torch.float32, 3)
    b, n, c = xyz.shape
    s = query.shape[1]
    if query.shape[0] != b or query.shape[2] != c:
        raise ValueError(f"knn: bad shapes {tuple(xyz.shape)}, {tuple(query.shape)}")
    stream = _kernels.stream_args(xyz)
    vec = c % 4 == 0 and xyz.data_ptr() % 16 == 0
    plan = _knn_c_plan(b, n, s, k, c, _kernels.sm_count(stream[0]), vec)
    idx = torch.empty(b, s, k, dtype=torch.int32, device=xyz.device)
    d2 = torch.empty(b, s, k, dtype=torch.float32, device=xyz.device)
    if idx.numel() == 0:
        return d2, idx
    _kernels.KNN_C.launch(xyz.data_ptr(), query.data_ptr(), idx.data_ptr(), d2.data_ptr(),
                          plan, *stream)
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
        # the kernel takes contiguous rows (the wrapper refuses strides); a
        # view such as the vote's colour columns of its gathered table
        # (infer/vote.py) goes as a copy, as query_ball_point's inputs do
        return group_cuda(xyz.contiguous(), new_xyz.contiguous(), idx.contiguous(),
                          None if features is None else features.contiguous())

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
GROUP_BWD_PLAN = ("b", "n", "s", "k", "width", "c0", "c1", "vec", "split")
# points a batch element that csrc/group_bwd.cu counts in shared memory
# (4 bytes a point: 128 KB)
GROUP_BWD_MAX_N = 32768
# slots a block of csrc/group_bwd.cu's count and place takes at least, and
# their blocks an SM over the whole grid
GROUP_BWD_SLICE = 2048
_GROUP_BWD_BLOCKS_AN_SM = 2


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


def group_backward_split(b: int, s: int, k: int, sms: int) -> int:
    """Blocks a batch element of csrc/group_bwd.cu's count and place: a
    slice of GROUP_BWD_SLICE slots or more each, and no more blocks over
    the batch than two an SM."""
    return max(1, min(-(-(s * k) // GROUP_BWD_SLICE), -(-_GROUP_BWD_BLOCKS_AN_SM * sms // b)))


def _check_group_backward(b: int, n: int, s: int, k: int, width: int, c0: int, c1: int) -> None:
    if not 0 <= c0 < c1 <= width or not 1 <= n <= GROUP_BWD_MAX_N:
        raise ValueError(f"group backward: bad channels [{c0}, {c1}) of {width} or N={n} "
                         f"outside [1, {GROUP_BWD_MAX_N}]")
    if b > 65535 or b * s * k >= _INT_LIMIT or -(-(c1 - c0) // 32) > 65535:
        raise ValueError(f"group backward kernel takes B <= 65535 and B * S * K < 2^31, "
                         f"got [{b}, {s}, {k}]")


@functools.lru_cache(maxsize=1024)
def _group_backward_plan(b: int, n: int, s: int, k: int, width: int, c0: int, c1: int,
                         split: int):
    """pcb_group_backward's plan (GROUP_BWD_PLAN), checked and laid out once
    a shape: four channels a lane where c1 - c0 is a multiple of 4; the
    count and place split over ``split`` blocks a batch element
    (``group_backward_split``)."""
    _check_group_backward(b, n, s, k, width, c0, c1)
    if not 1 <= split <= 65535:
        raise ValueError(f"group backward: split {split} outside [1, 65535]")
    vec = 4 if (c1 - c0) % 4 == 0 else 1
    return (ctypes.c_int * len(GROUP_BWD_PLAN))(b, n, s, k, width, c0, c1, vec, split)


@functools.lru_cache(maxsize=1024)
def _group_backward_launch(b: int, n: int, s: int, k: int, width: int, c0: int, c1: int,
                           device: int) -> tuple:
    """(plan, ints of scratch) of a group-backward launch on ``device``,
    worked out once a shape; the shape is checked before the device is
    read."""
    _check_group_backward(b, n, s, k, width, c0, c1)
    split = group_backward_split(b, s, k, _kernels.sm_count(device))
    plan = _group_backward_plan(b, n, s, k, width, c0, c1, split)
    return plan, group_backward_work(b, n, s, k, group_backward_chunks(c1 - c0, plan[7]), split)


def group_backward_chunks(wout: int, vec: int) -> int:
    """Channel chunks of csrc/group_bwd.cu's fold, a warp each a point:
    32 * vec channels a chunk."""
    return -(-wout // (32 * vec))


def group_backward_work(b: int, n: int, s: int, k: int, chunks: int, split: int) -> int:
    """Ints of scratch pcb_group_backward takes: the bucket ends [B, N], the
    count blocks' histograms [B, split, N], the buckets [B, S * K] and a
    sorted copy of them a chunk [B, chunks, S * K]."""
    return b * (n + split * n + (1 + chunks) * s * k)


def group_backward_cuda(
    g: torch.Tensor, idx: torch.Tensor, n: int, c0: int, c1: int
) -> torch.Tensor:
    """Group-backward kernel wrapper (csrc/group_bwd.cu, four launches a
    call): each point's row a left fold of its slots' rows in ascending
    slot order, so the same bits every call."""
    _kernels.check_tensor("g", g, torch.float32, 4)
    _kernels.check_tensor("idx", idx, torch.int32, 3)
    b, s, k, width = g.shape
    if idx.shape != (b, s, k):
        raise ValueError(f"group backward: g {tuple(g.shape)} vs idx {tuple(idx.shape)}")
    plan, work_ints = _group_backward_launch(b, n, s, k, width, c0, c1, g.get_device())
    out = torch.empty(b, n, c1 - c0, dtype=torch.float32, device=g.device)
    if b * s * k == 0:
        return out.zero_()
    work = torch.empty(work_ints, dtype=torch.int32, device=g.device)
    _kernels.GROUP_BWD.launch(g.data_ptr(), idx.data_ptr(), out.data_ptr(), work.data_ptr(),
                              plan, *_kernels.stream_args(g))
    return out


def group_backward_order(g: torch.Tensor, idx: torch.Tensor, n: int, c0: int,
                         c1: int) -> torch.Tensor:
    """The group backward in the kernel's order, in plain PyTorch: each
    point's row a left fold from 0.0 over its slots in ascending s * K + k,
    one float32 add at a time -> the kernel's bits. A slow emulation for
    holding the kernel (phase 3b of chip_smoke.py) and the tests: one
    elementwise add a step, as many steps as the longest bucket."""
    b, s, k, _ = g.shape
    flat = idx.reshape(b, s * k).clamp(0, n - 1).long()
    src = g[..., c0:c1].reshape(b, s * k, c1 - c0)
    # slots by (point, slot id): a stable sort by point keeps ascending ids
    order = flat.argsort(dim=1, stable=True)
    point = flat.gather(1, order)
    counts = torch.zeros((b, n), dtype=torch.long, device=g.device)
    counts.scatter_add_(1, flat, torch.ones_like(flat))
    first = torch.cumsum(counts, dim=1) - counts  # bucket starts
    rank = torch.arange(s * k, device=g.device).expand(b, -1) - first.gather(1, point)
    rows = src.gather(1, order.unsqueeze(-1).expand(-1, -1, c1 - c0))
    out = torch.zeros((b, n, c1 - c0), dtype=g.dtype, device=g.device)
    for q in range(int(counts.max()) if counts.numel() else 0):
        at = rank == q  # the q-th slot of each bucket
        step = torch.zeros_like(out)
        bi, pi = at.nonzero(as_tuple=True)
        step[bi, point[bi, pi]] = rows[bi, pi]
        has = torch.zeros((b, n), dtype=torch.bool, device=g.device)
        has[bi, point[bi, pi]] = True
        out = torch.where(has.unsqueeze(-1), out + step, out)
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


def edge_conv_graph_feature(
    x: torch.Tensor, k: int = 20, idx: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """DGCNN's dynamic-graph feature (ops/grouping.py:322-342): for each
    point i and each of its k neighbours j in x's own space, (x_j - x_i,
    x_i).

    x [B, N, C], idx [B, N, k] (default ``knn(x, k=k)``) -> [B, N, k, 2C],
    channel-last in that channel order. Differentiable in x: the gather is
    ``index_points``, whose backward on the card is the group-backward
    kernel (a fixed order of adds), as the JAX package gathers outside any
    Pallas kernel.
    """
    if idx is None:
        idx = knn(x, k=k)
    neighbours = index_points(x, idx)  # [B, N, k, C]
    center = x.unsqueeze(2).expand_as(neighbours)
    return torch.cat([neighbours - center, center], dim=-1)


def knn_stat_weighted(xyz: torch.Tensor, k: int = 16) -> torch.Tensor:
    """RandLANet_ss's statistically re-weighted k-NN (ops/grouping.py:254-280):
    the 2k nearest points (k-NN kernel), gathered by ``group_points`` about
    a zero centre (the group kernel: the candidates' own xyz, as the JAX
    line takes them), then ``knn_stat_select``. xyz [B, N, 3] -> [B, N, k]
    int32, no gradient."""
    n = xyz.shape[1]
    k = min(k, n)
    with torch.no_grad():
        d2, idx2 = knn_with_distance(xyz, k=min(2 * k, n))
        pts = group_points(xyz, torch.zeros_like(xyz), idx2)  # [B, N, 2k, 3]
        return knn_stat_select(pts, d2, idx2, k)


def stat_weighted_distance(pts: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """The 2k candidates' squared distances d2 [B, N, 2k], each weighted by
    exp(-|p - mean|^2 / mean(std + 1e-6)) over the candidates' xyz pts
    [B, N, 2k, 3] (their mean and unbiased std, as ``jnp.std(ddof=1)``)."""
    mean = pts.mean(dim=2, keepdim=True)
    std = pts.std(dim=2, unbiased=True)  # [B, N, 3]
    denom = (std + 1e-6).mean(dim=-1, keepdim=True)
    return d2 * torch.exp(-((pts - mean) ** 2).sum(dim=-1) / denom)


def knn_stat_select(pts: torch.Tensor, d2: torch.Tensor, idx2: torch.Tensor,
                    k: int) -> torch.Tensor:
    """The selection of ``knn_stat_weighted`` from the 2k-NN (d2, idx2)
    [B, N, 2k] and the candidates' xyz pts [B, N, 2k, 3]: the k smallest
    ``stat_weighted_distance``, by a stable argsort (equal values keep the
    nearer candidate first, as ``jnp.argsort``)."""
    order = stat_weighted_distance(pts, d2).argsort(dim=-1, stable=True)[..., :k]
    return idx2.gather(-1, order).to(torch.int32)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum`` over the first axis: data [E, C], segment_ids
    [E] -> [S, C], each segment the sum of its rows, an empty one 0. This is
    the group backward's function (the gradient of a gather): on the card
    the group-backward kernel adds each segment's rows in ascending row
    order, so the same bits every call (``index_add_`` adds with float
    atomics in an order that varies); on the CPU ``group_backward_plain``.
    Its gradient is a gather, :class:`SegmentSum`."""
    return SegmentSum.apply(data, segment_ids, num_segments)


class SegmentSum(torch.autograd.Function):
    """``segment_sum`` with a gather as its backward."""

    @staticmethod
    def forward(ctx, data, segment_ids, num_segments):
        e, c = data.shape
        ids = segment_ids.reshape(1, e, 1).to(torch.int32).contiguous()
        ctx.save_for_backward(ids)
        g = data.reshape(1, e, 1, c).contiguous()
        if data.is_cuda:
            return group_backward_cuda(g, ids, num_segments, 0, c)[0]
        return group_backward_plain(g, ids, num_segments, 0, c)[0]

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        return grad[ids.reshape(-1).long()], None, None
