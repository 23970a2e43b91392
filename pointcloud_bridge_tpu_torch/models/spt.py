"""The SuperPoint Transformer in PyTorch (counterpart of
pointcloud_bridge_tpu/models/spt.py).

:class:`SuperPointTransformer` is a graph transformer over one padded
superpoint graph: node features x [S, F], edges ``edge_index`` [2, E] (row
0 the source j, row 1 the target i), edge attributes [E, A] and an edge
mask, any degree a node. Attention is normalised over each node's incoming
edges (``segment_softmax``) and messages are summed into their targets.
:class:`SPTSegmenter` (``spt``) is the point-level model the registry
builds: the k-means partition of models/spg.py into S = max(16, N // 50)
superpoints (FPS seeds on the card), their statistics as node features, a
k-NN graph over the centroids (9 nearest, self dropped: the k-NN kernel),
the whole batch as one graph, and each point given its superpoint's
logits.

Gathers and sums with repeated indices add with float atomics in torch on
CUDA (``torch.gather``'s backward, ``index_add_``, ``scatter_add_``), in an
order that varies. Here every gather of a tensor with a gradient goes
through ``ops.core.index_points`` (its backward the group-backward kernel
on the card) and every sum into segments is ``ops.grouping.segment_sum``
(the group-backward kernel itself, its backward a gather), so a train step
gives the same bits every run. The segment max of the softmax is taken
without a gradient: the softmax does not depend on the shift, so the
gradient through it is 0 (JAX's is rounding noise about 0).

Layers under the flax names (``spt.input_proj.lin0``, ``spt.layer0.attn.q``,
``spt.layer0.ffn.bn0``, ``spt.output_proj.lin1``; a Dense [out, in]).
``axis_name`` syncs every BatchNorm over that mesh axis (``sync_batchnorms``); ``in_features`` is the
width of the features beside xyz (3, the colours the CLIs feed).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import index_points, knn
from ..ops.grouping import segment_sum
from .common import BatchNorm, Dense, Dropout, sync_batchnorms
from .ptv3 import LayerNorm
from .spg import kmeans_partition, segment_max, segment_stats


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [S, C] at the rows of idx [E] -> [E, C], through index_points."""
    return index_points(x.unsqueeze(0), idx.unsqueeze(0))[0]


def segment_softmax(scores: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Softmax over the entries that share a segment id (models/spt.py:26-32):
    scores [E, H], segment_ids [E] -> [E, H]."""
    with torch.no_grad():
        mx = segment_max(scores.unsqueeze(0), segment_ids.unsqueeze(0), num_segments)[0]
    ex = torch.exp(scores - gather_rows(mx, segment_ids))
    den = segment_sum(ex, segment_ids, num_segments)
    return ex / gather_rows(den, segment_ids).clamp_min(1e-12)


class GraphMLP(nn.Module):
    """Dense layers ``lin{i}``, BatchNorm ``bn{i}`` + ReLU + Dropout between
    them (models/spt.py:35-54)."""

    def __init__(self, in_ch: int, channels: Sequence[int], dropout: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.depth = len(channels)
        for i, c in enumerate(channels):
            setattr(self, f"lin{i}", Dense(in_ch, c, generator=generator))
            if i < self.depth - 1:
                setattr(self, f"bn{i}", BatchNorm(c))
                setattr(self, f"drop{i}", Dropout(dropout))
            in_ch = c

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = getattr(self, f"lin{i}")(x)
            if i < self.depth - 1:
                x = getattr(self, f"drop{i}")(F.relu(getattr(self, f"bn{i}")(x)))
        return x


class GraphMultiHeadAttention(nn.Module):
    """Edge-wise multi-head attention with sum aggregation
    (models/spt.py:57-87): per edge j -> i, q from x_i, k and v from x_j,
    the score q.k / sqrt(D) plus ``edge_proj`` of the edge attributes
    (where ``edge_dim`` is given), masked edges out, softmax over i's
    incoming edges, the weighted values summed into i, then ``o``."""

    def __init__(self, channels: int, num_heads: int, dropout: float = 0.1,
                 edge_dim: Optional[int] = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.channels, self.num_heads = channels, num_heads
        self.q = Dense(channels, channels, generator=g)
        self.k = Dense(channels, channels, generator=g)
        self.v = Dense(channels, channels, generator=g)
        self.edge_proj = None if edge_dim is None else Dense(edge_dim, num_heads, generator=g)
        self.drop = Dropout(dropout)
        self.o = Dense(channels, channels, generator=g)
        # sqrt(D) as a Python float: a tensor takes it at its own precision,
        # as JAX's weakly typed jnp.sqrt(D)
        self.scale = math.sqrt(channels // num_heads)

    def forward(self, x: torch.Tensor, edge_index: torch.Tensor,
                edge_attr: Optional[torch.Tensor], edge_mask: torch.Tensor) -> torch.Tensor:
        s, h = x.shape[0], self.num_heads
        d = self.channels // h
        src, dst = edge_index[0], edge_index[1]
        x_j, x_i = gather_rows(x, src), gather_rows(x, dst)
        q = self.q(x_i).reshape(-1, h, d)
        k = self.k(x_j).reshape(-1, h, d)
        v = self.v(x_j).reshape(-1, h, d)
        attn = (q * k).sum(dim=-1) / self.scale  # [E, H]
        if edge_attr is not None:
            if self.edge_proj is None:
                raise ValueError("GraphMultiHeadAttention: edge_attr given, but no edge_dim")
            attn = attn + self.edge_proj(edge_attr)
        mask = edge_mask.unsqueeze(-1)
        attn = torch.where(mask, attn, torch.full_like(attn, -1e9))
        w = segment_softmax(attn, dst, s)
        w = self.drop(torch.where(mask, w, torch.zeros_like(w)))
        msgs = (v * w.unsqueeze(-1)).reshape(-1, self.channels)
        return self.o(segment_sum(msgs, dst, s))


class GraphTransformerEncoder(nn.Module):
    """Pre-LN attention and feed-forward block (models/spt.py:90-114)."""

    def __init__(self, channels: int, num_heads: int, dropout: float = 0.1,
                 edge_dim: Optional[int] = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.norm1 = LayerNorm(channels)
        self.attn = GraphMultiHeadAttention(channels, num_heads, dropout, edge_dim, generator)
        self.drop1 = Dropout(dropout)
        self.norm2 = LayerNorm(channels)
        self.ffn = GraphMLP(channels, (channels * 4, channels), dropout, generator)
        self.drop2 = Dropout(dropout)

    def forward(self, x, edge_index, edge_attr, edge_mask):
        x = self.drop1(self.attn(self.norm1(x), edge_index, edge_attr, edge_mask)) + x
        return self.drop2(self.ffn(self.norm2(x))) + x


class SuperPointTransformer(nn.Module):
    """Input MLP -> ``num_layers`` graph-transformer encoders -> output MLP
    (models/spt.py:117-151): forward(x [S, in_channels], edge_index [2, E],
    edge_attr [E, edge_dim] or None, edge_mask [E] bool or None (all)) ->
    per-superpoint logits [S, num_classes]."""

    def __init__(self, num_classes: int = 5, hidden_channels: int = 128, num_layers: int = 4,
                 num_heads: int = 8, dropout: float = 0.1, axis_name: Optional[str] = None,
                 in_channels: int = 22, edge_dim: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g, hc = generator, hidden_channels
        self.num_layers = num_layers
        self.input_proj = GraphMLP(in_channels, (hc, hc), dropout, g)
        for i in range(num_layers):
            setattr(self, f"layer{i}",
                    GraphTransformerEncoder(hc, num_heads, dropout, edge_dim, g))
        self.output_proj = GraphMLP(hc, (hc // 2, num_classes), dropout, g)
        sync_batchnorms(self, axis_name)

    def forward(self, x: torch.Tensor, edge_index: torch.Tensor,
                edge_attr: Optional[torch.Tensor] = None,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if edge_mask is None:
            edge_mask = torch.ones(edge_index.shape[1], dtype=torch.bool, device=x.device)
        x = self.input_proj(x)
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}")(x, edge_index, edge_attr, edge_mask)
        return self.output_proj(x)


class SPTSegmenter(nn.Module):
    """The point-level SPT (models/spt.py:154-243): forward(xyz [B, N, 3],
    features [B, N, in_features] or None (xyz stands in)) -> logits
    [B, N, num_classes]. Node features [centroid | mean | std | max of
    [xyz | features] | log(1 + size)], edges from the knn_k nearest
    centroids with attributes [distance | x_i - x_j | c_j - c_i]."""

    def __init__(self, num_classes: int = 5, superpoint_size: int = 50,
                 hidden_channels: int = 128, num_layers: int = 4, num_heads: int = 8,
                 knn_k: int = 8, kmeans_iters: int = 3, dropout: float = 0.1,
                 axis_name: Optional[str] = None, in_features: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_classes, self.superpoint_size = num_classes, superpoint_size
        self.knn_k, self.kmeans_iters = knn_k, kmeans_iters
        node = 4 + 3 * (3 + in_features)
        self.spt = SuperPointTransformer(num_classes, hidden_channels, num_layers, num_heads,
                                         dropout, None, node, 1 + node + 3, generator)
        sync_batchnorms(self, axis_name)

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, n, _ = xyz.shape
        if features is None:
            features = xyz
        s = max(16, n // self.superpoint_size)
        assign, centroids, onehot = kmeans_partition(xyz, s, self.kmeans_iters)
        counts = onehot.sum(dim=1)
        mx, mean, std = segment_stats(torch.cat([xyz, features], dim=-1), onehot, assign)
        # log(1 + size) in float32, as the JAX model takes it from its
        # float32 one-hot
        size = torch.log1p(counts.float()).to(mean.dtype).unsqueeze(-1)
        node_x = torch.cat([centroids, mean, std, mx, size], dim=-1)  # [B, S, F]

        src = knn(centroids, k=min(self.knn_k + 1, s))[..., 1:]  # [B, S, kk], self dropped
        kk, nf = src.shape[-1], node_x.shape[-1]
        direction = index_points(centroids, src) - centroids.unsqueeze(2)
        dist = torch.linalg.norm(direction, dim=-1, keepdim=True)
        diff = node_x.unsqueeze(2) - index_points(node_x, src)
        edge_attr = torch.cat([dist, diff, direction], dim=-1)  # [B, S, kk, 1 + F + 3]

        # the batch as one graph, node ids offset by element
        offsets = (torch.arange(b, device=xyz.device) * s).view(b, 1, 1)
        tgt = torch.arange(s, device=xyz.device).view(1, s, 1).expand(b, s, kk)
        edge_index = torch.stack([(src.long() + offsets).reshape(-1),
                                  (tgt + offsets).reshape(-1)])
        sp_logits = self.spt(node_x.reshape(b * s, nf), edge_index,
                             edge_attr.reshape(b * s * kk, -1))
        return index_points(sp_logits.reshape(b, s, self.num_classes), assign)
