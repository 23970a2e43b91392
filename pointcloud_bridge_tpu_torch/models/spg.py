"""The Superpoint Graph model in PyTorch (counterpart of
pointcloud_bridge_tpu/models/spg.py).

A point encoder, a k-means partition into S = max(32, N // 50)
superpoints (seeded by FPS, the FPS kernel on the card), per-superpoint
[max, mean, std, median, q75] pooling with the reference's index-based
quantile picks (``segment_quantile_stats``), a superpoint graph over the
centroids' 33 nearest (self included) with 18-dim edge features, three
gated attentive graph convolutions with two top-k poolings between them,
context-aware global pooling, a classifier, and the global logits
propagated back to every point.

The discrete picks are functions of this module, so that a caller can
record and replay them (chip_smoke.py holds the card to the CPU that way):
``kmeans_partition`` (argmin over a cdist matrix), ``centroid_graph`` (the
top-k of -distance over the centroids, in the expanded distance form of
the JAX line: equal values to the lower index, as ``lax.top_k``) and
``top_k_nodes`` (the poolings' picks).

Gradients: the poolings' feature gather goes through ``index_points``
(the group-backward kernel on the card); the quantile picks' backward
(:class:`QuantilePick`) adds each cotangent at its picked point, at most
two (median and q75) at one point; the segment max is
``scatter_reduce("amax")``, whose backward spreads over ties as JAX's
segment max does.

Layers under the flax names (``point_encoder.dense_0``, ``gconv1.attn0``,
``gpool1.score0``, ``cls_bn1``, ``pfp_comb2``; a Dense [out, in]).
``axis_name`` syncs every BatchNorm over that mesh axis (``sync_batchnorms``); ``in_features`` is the
width of the features beside xyz (3, the colours the CLIs feed; xyz stands
in where none are given).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import farthest_point_sample, index_points
from ..ops.core import square_distance
from ..ops.structure import eigh3x3, min_eigvec3x3
from .common import BatchNorm, Dense, DenseMLP, Dropout, sync_batchnorms


def kmeans_partition(xyz: torch.Tensor, num_superpoints: int, iters: int = 3) -> tuple:
    """Batched k-means (models/spg.py:43-58): FPS seeds, then ``iters``
    rounds of argmin over the expanded squared distances and centroid
    means by a one-hot GEMM (an empty cluster keeps its centroid) ->
    (assign [B, N] int32, centroids [B, S, 3], onehot [B, N, S] float32)."""
    seeds = farthest_point_sample(xyz, num_superpoints)
    centroids = index_points(xyz, seeds)
    assign = onehot = None
    for _ in range(iters):
        assign = square_distance(xyz, centroids).argmin(dim=-1)
        onehot = F.one_hot(assign, num_superpoints).to(xyz.dtype)
        counts = onehot.sum(dim=1)  # [B, S]
        sums = torch.einsum("bns,bnc->bsc", onehot, xyz)
        new = sums / counts.clamp_min(1.0).unsqueeze(-1)
        centroids = torch.where(counts.unsqueeze(-1) > 0, new, centroids)
    return assign.to(torch.int32), centroids, onehot


def segment_max(feats: torch.Tensor, assign: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_max`` a batch element: feats [B, N, C], assign
    [B, N] -> [B, S, C], an empty segment 0."""
    b, _, c = feats.shape
    init = feats.new_full((b, num_segments, c), float("-inf"))
    idx = assign.long().unsqueeze(-1).expand_as(feats)
    mx = init.scatter_reduce(1, idx, feats, "amax", include_self=True)
    return torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))


def segment_stats(feats: torch.Tensor, onehot: torch.Tensor, assign: torch.Tensor) -> tuple:
    """Per-superpoint max, mean and std (models/spg.py:61-77): feats
    [B, N, C], onehot [B, N, S], assign [B, N] -> each [B, S, C]."""
    counts = onehot.sum(dim=1).clamp_min(1.0).unsqueeze(-1)
    mean = torch.einsum("bns,bnc->bsc", onehot, feats) / counts
    meansq = torch.einsum("bns,bnc->bsc", onehot, feats ** 2) / counts
    std = torch.sqrt(torch.relu(meansq - mean ** 2) + 1e-12)
    return segment_max(feats, assign, onehot.shape[-1]), mean, std


def sorted_by_segment(vals: torch.Tensor, segments: torch.Tensor) -> torch.Tensor:
    """The permutation that sorts the last axis by (segment, value): a
    stable sort by value, then a stable sort of that by segment (-0.0 and
    0.0 are equal values, as JAX's sort canonicalises them)."""
    by_value = vals.sort(dim=-1, stable=True).indices
    by_segment = segments.gather(-1, by_value).sort(dim=-1, stable=True).indices
    return by_value.gather(-1, by_segment)


class QuantilePick(torch.autograd.Function):
    """The index-based median and q75 of each segment (models/spg.py:80-135):
    vals [B, C, N] sorted by (segment of ``assign`` [B, N], value), stable
    (``sorted_by_segment``); the values at positions ``med_i`` and
    ``q75_i`` [B, S] -> (med, q75) each [B, C, S]. The backward adds each
    cotangent at the point its value came from: one add a point for each of
    the two, so the same bits in any order."""

    @staticmethod
    def forward(ctx, vals, assign, med_i, q75_i):
        b, c, n = vals.shape
        src = sorted_by_segment(vals, assign.long().unsqueeze(1).expand(b, c, n))
        picks = []
        for pos in (med_i, q75_i):
            at = src.gather(-1, pos.long().clamp(0, n - 1).unsqueeze(1).expand(b, c, -1))
            picks.append((vals.gather(-1, at), at))
        ctx.save_for_backward(picks[0][1], picks[1][1])
        ctx.n = n
        return picks[0][0], picks[1][0]

    @staticmethod
    def backward(ctx, dmed, dq75):
        med_src, q75_src = ctx.saved_tensors
        b, c, _ = med_src.shape
        dv = dmed.new_zeros((b, c, ctx.n))
        dv.scatter_add_(-1, med_src, dmed)
        dv.scatter_add_(-1, q75_src, dq75)
        return dv, None, None, None


def segment_quantile_stats(feats: torch.Tensor, onehot: torch.Tensor,
                           assign: torch.Tensor) -> tuple:
    """Per-superpoint [max, mean, std, median, q75] as the reference pools
    (models/spg.py:138-194): std unbiased + 1e-6 and 0 at a count of 1 or
    less; the median and q75 the values at sorted[min(cnt // 2, cnt - 1)]
    and sorted[min(3 cnt // 4, cnt - 1)]; every statistic 0 for an empty
    superpoint. feats [B, N, C], onehot [B, N, S], assign [B, N] -> each
    [B, S, C]."""
    counts = onehot.sum(dim=1)  # [B, S]
    cnt = counts.to(torch.int64)
    ssum = torch.einsum("bns,bnc->bsc", onehot, feats)
    mean = ssum / counts.clamp_min(1.0).unsqueeze(-1)
    sq = torch.einsum("bns,bnc->bsc", onehot, feats ** 2)
    var = (sq - ssum * mean) / (counts - 1.0).clamp_min(1.0).unsqueeze(-1)
    std = torch.sqrt(torch.relu(var)) + 1e-6
    zero = torch.zeros_like(mean)
    std = torch.where(cnt.unsqueeze(-1) > 1, std, zero)
    mx = segment_max(feats, assign, onehot.shape[-1])
    start = torch.cumsum(cnt, dim=-1) - cnt
    last = (cnt - 1).clamp_min(0)
    med_i = start + torch.minimum(cnt // 2, last)
    q75_i = start + torch.minimum(3 * cnt // 4, last)
    med, q75 = QuantilePick.apply(feats.transpose(1, 2), assign, med_i, q75_i)
    nonempty = cnt.unsqueeze(-1) > 0
    med = torch.where(nonempty, med.transpose(1, 2), zero)
    q75 = torch.where(nonempty, q75.transpose(1, 2), zero)
    return mx, torch.where(nonempty, mean, zero), std, med, q75


def centroid_graph(centroids: torch.Tensor, k: int) -> tuple:
    """The superpoint graph's neighbours (models/spg.py:333-336): the
    expanded squared distances [B, S, S] and the k largest of their
    negation [B, S, k], self included, equal values to the lower index."""
    dmat = square_distance(centroids, centroids)
    return dmat, top_k_nodes(-dmat, k)


def top_k_nodes(scores: torch.Tensor, k: int) -> torch.Tensor:
    """``lax.top_k``'s indices over the last axis: the k largest, largest
    first, equal values to the lower index."""
    return scores.sort(dim=-1, descending=True, stable=True).indices[..., :k]


class EnhancedGraphConv(nn.Module):
    """Gated attentive graph convolution (models/spg.py:197-232), dense over
    [B, S, S]: masked softmax attention of [x_i | x_j | edge MLP] over the
    adjacency, messages of the neighbour transform gated by [x_j | edge
    MLP], [self | messages] through two Dense."""

    def __init__(self, in_ch: int, out_channels: int, edge_dim: int = 18,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g, co = generator, out_channels
        self.self_transform = Dense(in_ch, co, generator=g)
        self.neighbor_transform = Dense(in_ch, co, generator=g)
        self.edge_mlp0 = Dense(edge_dim, 32, generator=g)
        self.edge_mlp1 = Dense(32, 32, generator=g)
        self.attn0 = Dense(2 * in_ch + 32, 32, generator=g)
        self.attn1 = Dense(32, 1, generator=g)
        self.gate0 = Dense(in_ch + 32, 64, generator=g)
        self.gate1 = Dense(64, co, generator=g)
        self.combine0 = Dense(2 * co, co, generator=g)
        self.combine1 = Dense(co, co, generator=g)

    def forward(self, x: torch.Tensor, adjacency: torch.Tensor,
                edge_features: torch.Tensor) -> torch.Tensor:
        b, s, c = x.shape
        self_feat = self.self_transform(x)
        tn = self.neighbor_transform(x)
        eh = F.relu(self.edge_mlp1(F.relu(self.edge_mlp0(edge_features))))  # [B, S, S, 32]
        xi = x.unsqueeze(2).expand(b, s, s, c)
        xj = x.unsqueeze(1).expand(b, s, s, c)
        a = self.attn1(F.relu(self.attn0(torch.cat([xi, xj, eh], dim=-1)))).squeeze(-1)
        linked = adjacency > 0
        a = torch.softmax(torch.where(linked, a, torch.full_like(a, -1e9)), dim=-1)
        a = torch.where(linked, a, torch.zeros_like(a))  # an isolated row sends nothing
        gate = torch.sigmoid(self.gate1(F.relu(self.gate0(torch.cat([xj, eh], dim=-1)))))
        msgs = torch.einsum("bij,bijc->bic", a, tn.unsqueeze(1) * gate)
        h = F.relu(self.combine0(torch.cat([self_feat, msgs], dim=-1)))
        return self.combine1(h)


class HierarchicalGraphPooling(nn.Module):
    """Top-k node pooling by a learned score (models/spg.py:235-252): keeps
    k = min(max(4, int(S * ratio)), S) nodes, their features (a gather with
    a gradient), adjacency and edge features."""

    def __init__(self, in_ch: int, ratio: float = 0.5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.ratio = ratio
        self.score0 = Dense(in_ch, 64, generator=g)
        self.score1 = Dense(64, 16, generator=g)
        self.score2 = Dense(16, 1, generator=g)

    def forward(self, x: torch.Tensor, adjacency: torch.Tensor,
                edge_features: torch.Tensor) -> tuple:
        s = x.shape[1]
        scores = self.score2(F.relu(self.score1(F.relu(self.score0(x))))).squeeze(-1)
        k = min(max(4, int(s * self.ratio)), s)
        idx = top_k_nodes(scores, k).long()  # [B, k]
        bi = torch.arange(x.shape[0], device=x.device)[:, None, None]
        rows, cols = idx.unsqueeze(-1), idx.unsqueeze(1)
        return index_points(x, idx), adjacency[bi, rows, cols], edge_features[bi, rows, cols]


class ContextAwareGraphPooling(nn.Module):
    """Attention-weighted global pooling (models/spg.py:255-267):
    [B, S, C] -> [B, out_channels]."""

    def __init__(self, in_ch: int, out_channels: int = 1024,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.attn0 = Dense(in_ch, 64, generator=g)
        self.attn1 = Dense(64, 1, generator=g)
        self.global0 = Dense(in_ch, 512, generator=g)
        self.global1 = Dense(512, out_channels, generator=g)

    def forward(self, x: torch.Tensor, adjacency: torch.Tensor = None) -> torch.Tensor:
        a = torch.softmax(self.attn1(F.relu(self.attn0(x))).squeeze(-1), dim=-1)
        pooled = torch.einsum("bs,bsc->bc", a, x)
        return F.relu(self.global1(F.relu(self.global0(pooled))))


class SuperpointGraph(nn.Module):
    """SuperpointGraph (models/spg.py:270-377): forward(xyz [B, N, 3],
    features [B, N, in_features] or None) -> logits [B, N, num_classes]."""

    def __init__(self, num_classes: int = 5, superpoint_size: int = 50, emb_dims: int = 1024,
                 kmeans_iters: int = 3, knn_k: int = 32, axis_name: Optional[str] = None,
                 dropout_rate: float = 0.5, in_features: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.superpoint_size, self.kmeans_iters, self.knn_k = superpoint_size, kmeans_iters, knn_k
        self.point_encoder = DenseMLP(3 + in_features, (64, 128, 256, 256), g)
        self.sp_encoder = DenseMLP(256, (256, 256, 256), g)
        for i, (cin, cout) in enumerate(((256, 256), (256, 384), (384, 512)), start=1):
            setattr(self, f"gconv{i}", EnhancedGraphConv(cin, cout, generator=g))
            setattr(self, f"gbn{i}", BatchNorm(cout))
        self.gpool1 = HierarchicalGraphPooling(256, 0.5, g)
        self.gpool2 = HierarchicalGraphPooling(384, 0.5, g)
        self.gpooling = ContextAwareGraphPooling(512, emb_dims, g)
        self.cls_fc1 = Dense(emb_dims, 512, generator=g)
        self.cls_bn1 = BatchNorm(512)
        self.cls_fc2 = Dense(512, 256, generator=g)
        self.cls_bn2 = BatchNorm(256)
        self.cls_fc3 = Dense(256, num_classes, generator=g)
        self.dp1 = Dropout(dropout_rate)
        self.dp2 = Dropout(dropout_rate)
        self.pfp_mlp0 = Dense(256, 128, generator=g)
        self.pfp_mlp1 = Dense(128, 64, generator=g)
        self.pfp_comb0 = Dense(64 + num_classes, 128, generator=g)
        self.pfp_comb1 = Dense(128, 64, generator=g)
        self.pfp_comb2 = Dense(64, num_classes, generator=g)
        sync_batchnorms(self, axis_name)

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, n, _ = xyz.shape
        if features is None:
            features = xyz
        point_feats = self.point_encoder(torch.cat([xyz, features], dim=-1))  # [B, N, 256]

        s = max(32, n // self.superpoint_size)
        assign, centroids, onehot = kmeans_partition(xyz, s, self.kmeans_iters)
        counts = onehot.sum(dim=1)
        mx, mean, std, med, q75 = segment_quantile_stats(point_feats, onehot, assign)
        sp_feats = 0.5 * mx + 0.2 * mean + 0.1 * std + 0.1 * med + 0.1 * q75
        sp_feats = self.sp_encoder(sp_feats)

        # shape descriptor a superpoint: eigenvalues, principal direction,
        # std of x and y
        safe = counts.clamp_min(1.0).unsqueeze(-1)
        xyz_mean = torch.einsum("bns,bnc->bsc", onehot, xyz) / safe
        xyz_sq = torch.einsum("bns,bnc->bsc", onehot, xyz ** 2) / safe
        var = torch.relu(xyz_sq - xyz_mean ** 2)
        exy = torch.einsum("bns,bni,bnj->bsij", onehot, xyz, xyz) / safe.unsqueeze(-1)
        cov = exy - torch.einsum("bsi,bsj->bsij", xyz_mean, xyz_mean)
        ev = eigh3x3(cov)
        tr = cov[..., 0, 0] + cov[..., 1, 1] + cov[..., 2, 2]
        eye = torch.eye(3, dtype=cov.dtype, device=cov.device)
        principal = min_eigvec3x3(tr[..., None, None] * eye - cov)
        shape_feats = torch.cat([ev, principal, torch.sqrt(var[..., :2] + 1e-12)], dim=-1)

        dmat, nbr = centroid_graph(centroids, min(self.knn_k + 1, s))
        adj = F.one_hot(nbr.long(), s).to(xyz.dtype).sum(dim=2)  # [B, S, S]
        dirs = centroids.unsqueeze(1) - centroids.unsqueeze(2)  # c_j - c_i
        sf_i = shape_feats.unsqueeze(2).expand(b, s, s, 8)
        sf_j = shape_feats.unsqueeze(1).expand(b, s, s, 8)
        edge_feats = torch.cat([torch.sqrt(torch.relu(dmat)).unsqueeze(-1), dirs, sf_j - sf_i,
                                sf_j[..., :6]], dim=-1)  # [B, S, S, 18]

        h = F.relu(self.gbn1(self.gconv1(sp_feats, adj, edge_feats)))
        h, adj1, ef1 = self.gpool1(h, adj, edge_feats)
        h = F.relu(self.gbn2(self.gconv2(h, adj1, ef1)))
        h, adj2, ef2 = self.gpool2(h, adj1, ef1)
        h = F.relu(self.gbn3(self.gconv3(h, adj2, ef2)))
        glob = self.gpooling(h, adj2)

        c = self.dp1(F.relu(self.cls_bn1(self.cls_fc1(glob))))
        c = self.dp2(F.relu(self.cls_bn2(self.cls_fc2(c))))
        global_logits = self.cls_fc3(c)  # [B, num_classes]

        p = F.relu(self.pfp_mlp1(F.relu(self.pfp_mlp0(point_feats))))
        p = torch.cat([p, global_logits.unsqueeze(1).expand(b, n, -1)], dim=-1)
        p = F.relu(self.pfp_comb1(F.relu(self.pfp_comb0(p))))
        return self.pfp_comb2(p)
