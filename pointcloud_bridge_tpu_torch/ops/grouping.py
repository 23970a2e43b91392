"""Ball query and grouping (counterpart of pointcloud_bridge_tpu/ops/grouping.py).

Only the exact semantics are ported: there is no ``approx`` and no
``recall_target``. A CPU tensor goes to the plain PyTorch version, a CUDA
tensor to the kernel (csrc/ballq.cu, csrc/group.cu); both give the same
result bit for bit. ``group_points`` is the autograd Function
:class:`GroupPoints` on both devices; its backward is a scatter-add, the
kernel csrc/group_bwd.cu on the card.
"""

from __future__ import annotations

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


def group_cuda(xyz, new_xyz, idx, features=None) -> torch.Tensor:
    """Group kernel wrapper: one launch writes all 3 + C channels."""
    _kernels.check_tensor("xyz", xyz, torch.float32, 3)
    _kernels.check_tensor("new_xyz", new_xyz, torch.float32, 3)
    _kernels.check_tensor("idx", idx, torch.int32, 3)
    b, n, _ = xyz.shape
    _, s, k = idx.shape
    c = 0
    if features is not None:
        _kernels.check_tensor("features", features, torch.float32, 3)
        c = features.shape[2]
        if features.shape[:2] != (b, n):
            raise ValueError(f"group: features {tuple(features.shape)} vs xyz {tuple(xyz.shape)}")
    if xyz.shape[2] != 3 or new_xyz.shape != (b, s, 3) or idx.shape[0] != b:
        raise ValueError(
            f"group: bad shapes {tuple(xyz.shape)}, {tuple(new_xyz.shape)}, {tuple(idx.shape)}"
        )
    out = torch.empty((b, s, k, 3 + c), dtype=torch.float32, device=xyz.device)
    if out.numel() >= 2**30:
        raise ValueError(f"group kernel takes < 2^30 output elements, got {out.numel()}")
    if out.numel() == 0:
        return out
    _kernels.GROUP.launch(
        xyz.data_ptr(), new_xyz.data_ptr(), idx.data_ptr(),
        features.data_ptr() if features is not None else None,
        out.data_ptr(), b, n, s, k, c, *_kernels.stream_args(xyz),
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


def group_backward_cuda(
    g: torch.Tensor, idx: torch.Tensor, n: int, c0: int, c1: int
) -> torch.Tensor:
    """Group-backward kernel wrapper: one launch (csrc/group_bwd.cu)."""
    _kernels.check_tensor("g", g, torch.float32, 4)
    _kernels.check_tensor("idx", idx, torch.int32, 3)
    b, s, k, width = g.shape
    if idx.shape != (b, s, k) or not 0 <= c0 < c1 <= width or n < 1:
        raise ValueError(
            f"group backward: bad shapes g {tuple(g.shape)}, idx {tuple(idx.shape)}, "
            f"channels [{c0}, {c1}), N={n}"
        )
    out = torch.empty((b, n, c1 - c0), dtype=torch.float32, device=g.device)
    total = b * s * k * (c1 - c0)
    if total >= 2**30 or out.numel() >= 2**31:
        raise ValueError(f"group backward kernel takes < 2^30 elements, got {total}")
    if total == 0:
        return out.zero_()
    _kernels.GROUP_BWD.launch(
        g.data_ptr(), idx.data_ptr(), out.data_ptr(), b, n, s, k, width, c0, c1,
        *_kernels.stream_args(g),
    )
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
