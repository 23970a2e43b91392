"""Attention and encoding modules of BriStruNet and of
``enhanced_pointnet2_ssg`` (counterpart of
pointcloud_bridge_tpu/models/attention.py), channel-last, with the flax
modules' names for every layer.

All ten modules of the JAX file are here: the five BriStruNet uses
(BridgeStructureEncoding, ColorFeatureExtraction, CompositeFeatureFusion,
GeometricFeatureExtraction, MultiScaleFeatureFusion), the two encodings of
``enhanced_pointnet2_ssg`` (EnhancedPositionalEncoding, and
SinusoidalPositionalEncoding, which no model of either package uses), and
its attention blocks (EnhancedAttentionModule, BoundaryAwareModule; and
StructuralAwareModule, which no model uses). A module whose JAX Dense reads
its width off the input takes that width (``channels``) when built.

``sp_axis`` on BridgeStructureEncoding, GeometricFeatureExtraction and
MultiScaleFeatureFusion is BriStruNet's sequence parallelism in the
whole-input contract (models/attention.py:64-109, 211-231, 316-341 of the
JAX package): the per-query work runs on this rank's slice of the points
and is gathered back, or left sliced for a pointwise consumer.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import index_points, knn
from ..ops.structure import knn_relative_positions, local_structure_features
from ..utils.collectives import all_gather, axis_size, sp_shard_slice
from .common import BatchNorm, Dense, Dropout


class BridgeStructureEncoding(nn.Module):
    """Grid-quantised absolute sin/cos encoding, k-NN relative positions and
    the 13-dim local structure statistics -> per-neighbour MLP -> max over
    the k neighbours (models/attention.py:49-110). [B, N, 3] -> [B, N,
    channels].

    The first Dense of the reference acts on [abs_enc | rel_pos | struct]
    per neighbour; abs_enc and struct are the same for all k neighbours, so
    it is split into ``mlp0_shared`` on [B, N, 6F + 13] (no bias) and
    ``mlp0_rel`` on the 3 relative coordinates, as in the JAX module. The
    BatchNorm runs over the 4-D [B, N, k, C] tensor. With ``sp_axis`` the
    queries are this rank's slice of the points (the k-NN over the whole
    cloud), gathered back unless ``sp_gather`` is False.
    """

    def __init__(self, channels: int = 32, k_neighbors: int = 16,
                 freq_bands: int = 4, grid_size: float = 1.0,
                 generator: Optional[torch.Generator] = None, sp_axis=None,
                 sp_gather: bool = True):
        super().__init__()
        self.sp_axis, self.sp_gather = sp_axis, sp_gather
        self.k_neighbors = k_neighbors
        self.freq_bands = freq_bands
        self.grid_size = grid_size
        self.mlp0_shared = Dense(6 * freq_bands + 13, channels, bias=False,
                                 generator=generator)
        self.mlp0_rel = Dense(3, channels, generator=generator)
        self.bn0 = BatchNorm(channels)
        self.mlp1 = Dense(channels, channels, generator=generator)

    def forward(self, xyz: torch.Tensor) -> torch.Tensor:
        k = min(self.k_neighbors, xyz.shape[1])
        q_xyz = sp_shard_slice(xyz, self.sp_axis) if self.sp_axis else xyz
        grid_xyz = torch.floor(q_xyz / self.grid_size) * self.grid_size
        abs_enc = []
        for band in range(self.freq_bands):
            f = float(2 ** band)
            abs_enc.append(torch.sin(grid_xyz * f))
            abs_enc.append(torch.cos(grid_xyz * f))

        # the neighbours feed order-free statistics and a max-pooled MLP
        rel_pos, _ = knn_relative_positions(
            xyz, k, ordered=False, query=q_xyz if self.sp_axis else None)
        struct = local_structure_features(rel_pos)  # [B, N, 13]

        shared = self.mlp0_shared(torch.cat(abs_enc + [struct], dim=-1))
        h = shared.unsqueeze(2) + self.mlp0_rel(rel_pos)  # [B, N, k, C]
        h = self.mlp1(F.relu(self.bn0(h)))
        out = torch.amax(h, dim=2)
        return all_gather(out, self.sp_axis) if self.sp_axis and self.sp_gather else out


class ColorFeatureExtraction(nn.Module):
    """Colour MLP, channel attention and a global-context gate
    (models/attention.py:169-191). [B, N, in_channels] -> [B, N,
    out_channels]."""

    def __init__(self, out_channels: int = 32, in_channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g, oc = generator, out_channels
        self.mlp0 = Dense(in_channels, 16, generator=g)
        self.bn0 = BatchNorm(16)
        self.mlp1 = Dense(16, oc, generator=g)
        self.bn1 = BatchNorm(oc)
        self.attn0 = Dense(oc, oc, generator=g)
        self.attn_bn = BatchNorm(oc)
        self.attn1 = Dense(oc, oc, generator=g)
        self.ctx0 = Dense(oc, oc // 2, generator=g)
        self.ctx1 = Dense(oc // 2, oc, generator=g)

    def forward(self, colors: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn0(self.mlp0(colors)))
        h = F.relu(self.bn1(self.mlp1(h)))
        a = F.relu(self.attn_bn(self.attn0(h)))
        enhanced = h * torch.sigmoid(self.attn1(a))
        ctx = h.mean(dim=1, keepdim=True)  # the mean over the points
        ctx = torch.sigmoid(self.ctx1(F.relu(self.ctx0(ctx))))
        return enhanced * ctx


class CompositeFeatureFusion(nn.Module):
    """Concatenate, then Dense + BatchNorm + ReLU
    (models/attention.py:194-204)."""

    def __init__(self, in_channels: int, out_channels: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fusion = Dense(in_channels, out_channels, generator=generator)
        self.bn = BatchNorm(out_channels)

    def forward(self, spatial: torch.Tensor, color: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.fusion(torch.cat([spatial, color], dim=-1))))


class GeometricFeatureExtraction(nn.Module):
    """Concatenate a 16-channel BridgeStructureEncoding of xyz (k = 16, 4
    frequency bands), then a 2-layer MLP (models/attention.py:207-232).
    [B, N, C] -> [B, N, C]. With ``sp_axis`` the encoding and the MLP run on
    this rank's slice, gathered back at the end."""

    def __init__(self, channels: int,
                 generator: Optional[torch.Generator] = None, sp_axis=None):
        super().__init__()
        self.sp_axis = sp_axis
        self.br_pos = BridgeStructureEncoding(16, generator=generator, sp_axis=sp_axis,
                                              sp_gather=False)
        self.mlp0 = Dense(channels + 16, channels, generator=generator)
        self.bn0 = BatchNorm(channels)
        self.mlp1 = Dense(channels, channels, generator=generator)

    def forward(self, x: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
        if self.sp_axis:
            x = sp_shard_slice(x, self.sp_axis)
        h = torch.cat([x, self.br_pos(xyz)], dim=-1)
        out = self.mlp1(F.relu(self.bn0(self.mlp0(h))))
        return all_gather(out, self.sp_axis) if self.sp_axis else out


def resize_nearest(feat: torch.Tensor, n: int) -> torch.Tensor:
    """[B, M, C] -> [B, n, C] by nearest-neighbour resize of the point axis
    as ``jax.image.resize(method="nearest")`` samples it: row i reads
    floor((i + 0.5) * M / n), computed in float32.
    (``F.interpolate(mode="nearest")`` reads floor(i * M / n), other rows.)"""
    m = feat.shape[1]
    if m == n:
        return feat
    rows = (torch.arange(n, dtype=torch.float32, device=feat.device) + 0.5) * m / n
    return feat[:, rows.floor().long()]


class MultiScaleFeatureFusion(nn.Module):
    """Resize every feature map to the last one's point count, then a Dense
    + BatchNorm + ReLU a scale (``conv{i}``, ``bn{i}``), concatenated
    (models/attention.py:311-345). With ``sp_axis`` the last map is this
    rank's slice of the fine points; the others, whole, are resized to the
    whole fine count and then sliced (a nearest resize maps each row on its
    own), and the output stays sliced."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 128,
                 generator: Optional[torch.Generator] = None, sp_axis=None):
        super().__init__()
        self.sp_axis = sp_axis
        self.scales = len(in_channels)
        for i, c in enumerate(in_channels):
            setattr(self, f"conv{i}", Dense(c, out_channels, generator=generator))
            setattr(self, f"bn{i}", BatchNorm(out_channels))

    def forward(self, features_list: Sequence[torch.Tensor]) -> torch.Tensor:
        n = features_list[-1].shape[1]
        last = len(features_list) - 1
        if self.sp_axis:
            n *= axis_size(self.sp_axis)  # the whole fine count
        outs = []
        for i, feat in enumerate(features_list):
            if not (self.sp_axis and i == last):
                feat = resize_nearest(feat, n)
                if self.sp_axis:
                    feat = sp_shard_slice(feat, self.sp_axis)
            h = getattr(self, f"conv{i}")(feat)
            outs.append(F.relu(getattr(self, f"bn{i}")(h)))
        return torch.cat(outs, dim=-1)


def norm3(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """The Euclidean norm over the last axis as ``jnp.linalg.norm`` takes
    it: sqrt of the sum of squares."""
    return torch.sqrt((v * v).sum(-1, keepdim=keepdim))


def frequency_encoding(x: torch.Tensor, bands: int) -> list:
    """[sin(x f), cos(x f)] for f = 1, 2, 4, ... 2^(bands - 1)."""
    enc = []
    for band in range(bands):
        f = float(2 ** band)
        enc += [torch.sin(x * f), torch.cos(x * f)]
    return enc


class SinusoidalPositionalEncoding(nn.Module):
    """sin/cos frequency encoding of xyz, then a linear projection ``proj``
    (models/attention.py:31-46). [B, N, 3] -> [B, N, channels]."""

    def __init__(self, channels: int = 64, freq_bands: int = 16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.freq_bands = freq_bands
        self.proj = Dense(6 * freq_bands, channels, generator=generator)

    def forward(self, xyz: torch.Tensor) -> torch.Tensor:
        return self.proj(torch.cat(frequency_encoding(xyz, self.freq_bands), dim=-1))


class EnhancedPositionalEncoding(nn.Module):
    """Relative frequency encoding and the 22-dim covariance / PCA /
    curvature structure encoding of each point's k-NN set
    (models/attention.py:113-166). [B, N, 3] -> [B, N, channels]: the mean
    over the k neighbours of ``rel_mlp0`` -> ``rel_bn`` (over [B, N, k, C])
    -> ReLU -> ``rel_mlp1`` on [sin, cos of rel_pos * 2^f | dist | unit],
    beside ``struct_mlp0`` -> ``struct_bn`` -> ReLU -> ``struct_mlp1`` on
    [cov (9) | linearity, planarity, sphericity | radius, density,
    curvature, direction consistency | mean (3) | std (3)], each half the
    channels. The neighbours come from ``knn_set`` (K5 on the card)."""

    def __init__(self, channels: int = 32, freq_bands: int = 4, k_neighbors: int = 16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g, half = generator, channels // 2
        self.freq_bands = freq_bands
        self.k_neighbors = k_neighbors
        self.rel_mlp0 = Dense(6 * freq_bands + 4, half, generator=g)
        self.rel_bn = BatchNorm(half)
        self.rel_mlp1 = Dense(half, half, generator=g)
        self.struct_mlp0 = Dense(22, half, generator=g)
        self.struct_bn = BatchNorm(half)
        self.struct_mlp1 = Dense(half, half, generator=g)

    def forward(self, xyz: torch.Tensor) -> torch.Tensor:
        k = min(self.k_neighbors, xyz.shape[1])
        rel_pos, _ = knn_relative_positions(xyz, k, ordered=False)  # [B, N, k, 3]

        dist = norm3(rel_pos, keepdim=True)
        unit = rel_pos / (dist + 1e-8)
        rel_feat = torch.cat(frequency_encoding(rel_pos, self.freq_bands) + [dist, unit], dim=-1)
        h = self.rel_bn(self.rel_mlp0(rel_feat))
        rel_encoding = self.rel_mlp1(F.relu(h)).mean(dim=2)  # [B, N, half]

        cov = torch.einsum("bnki,bnkj->bnij", rel_pos, rel_pos) / (k - 1)
        struct13 = local_structure_features(rel_pos)
        d_off = norm3(rel_pos - rel_pos.mean(dim=2, keepdim=True))  # [B, N, k]
        local_radius = d_off.amax(dim=-1)
        density = k / (local_radius + 1e-8)
        sorted_d = d_off.sort(dim=-1).values
        curvature = (sorted_d[..., 1:] - sorted_d[..., :-1]).mean(dim=-1)
        geom = torch.stack([local_radius, density, curvature, struct13[..., 6]], dim=-1)
        struct22 = torch.cat([cov.reshape(cov.shape[:2] + (9,)), struct13[..., 0:3], geom,
                              rel_pos.mean(dim=2), rel_pos.std(dim=2, unbiased=True)], dim=-1)
        s = self.struct_mlp1(F.relu(self.struct_bn(self.struct_mlp0(struct22))))
        return torch.cat([rel_encoding, s], dim=-1)


class BoundaryAwareModule(nn.Module):
    """k-NN feature-difference boundary attention (models/attention.py:
    235-269). x [B, N, channels], xyz [B, N, 3] -> [B, N, channels]: the
    ordered k-NN of xyz (K5 on the card); a spatial branch on the mean
    relative position and distance (``spatial0``, ``spatial_bn``,
    ``spatial1``); a boundary branch on [x | max over the neighbours of
    x_j - x_i] (``boundary0``, ``boundary_bn0``, ``boundary1``,
    ``boundary_bn1``); a gate ``attn0`` -> ``attn_bn`` -> ``attn1`` on [x |
    spatial]; x + boundary * gate. The neighbours' features are gathered by
    ``index_points``, whose backward on the card is the group-backward
    kernel."""

    def __init__(self, channels: int, k: int = 16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g, c = generator, channels
        self.k = k
        self.spatial0 = Dense(4, 32, generator=g)
        self.spatial_bn = BatchNorm(32)
        self.spatial1 = Dense(32, 64, generator=g)
        self.boundary0 = Dense(2 * c, c, generator=g)
        self.boundary_bn0 = BatchNorm(c)
        self.boundary1 = Dense(c, c, generator=g)
        self.boundary_bn1 = BatchNorm(c)
        self.attn0 = Dense(c + 64, c // 2, generator=g)
        self.attn_bn = BatchNorm(c // 2)
        self.attn1 = Dense(c // 2, c, generator=g)

    def forward(self, x: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
        idx = knn(xyz, k=min(self.k, xyz.shape[1]))
        rel = index_points(xyz, idx) - xyz.unsqueeze(2)
        spatial = torch.cat([rel.mean(dim=2), norm3(rel, keepdim=True).mean(dim=2)], dim=-1)
        s = self.spatial1(F.relu(self.spatial_bn(self.spatial0(spatial))))
        local_diff = index_points(x, idx) - x.unsqueeze(2)  # [B, N, k, C]
        b = torch.cat([x, local_diff.amax(dim=2)], dim=-1)
        b = F.relu(self.boundary_bn0(self.boundary0(b)))
        b = F.relu(self.boundary_bn1(self.boundary1(b)))
        a = F.relu(self.attn_bn(self.attn0(torch.cat([x, s], dim=-1))))
        return x + b * torch.sigmoid(self.attn1(a))


class StructuralAwareModule(nn.Module):
    """Global-context gated structure features (models/attention.py:
    272-287). [B, N, channels] -> [B, N, channels]: x + (``struct0`` ->
    ``struct_bn`` -> ReLU -> ``struct1``) * sigmoid(``ctx1``(ReLU(``ctx_bn``
    (``ctx0``(max over the points))))); ``ctx_bn`` normalises [B, 1, C / 4]
    over the batch."""

    def __init__(self, channels: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        g, c = generator, channels
        self.struct0 = Dense(c, c, generator=g)
        self.struct_bn = BatchNorm(c)
        self.struct1 = Dense(c, c, generator=g)
        self.ctx0 = Dense(c, c // 4, generator=g)
        self.ctx_bn = BatchNorm(c // 4)
        self.ctx1 = Dense(c // 4, c, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.struct1(F.relu(self.struct_bn(self.struct0(x))))
        ctx = F.relu(self.ctx_bn(self.ctx0(x.amax(dim=1, keepdim=True))))
        return x + h * torch.sigmoid(self.ctx1(ctx))


class EnhancedAttentionModule(nn.Module):
    """Channel and spatial attention (models/attention.py:290-308).
    [B, N, channels] -> [B, N, channels]: a channel gate from the mean over
    the points (``ca0`` -> ReLU -> dropout -> ``ca1`` -> sigmoid), then a
    spatial gate a point (``sa0`` -> ``sa_bn`` -> ReLU -> dropout -> ``sa1``
    -> sigmoid); x + x_ca * gate. ``dropout`` is the JAX module's attribute
    (0.5), for both Dropouts."""

    def __init__(self, channels: int, dropout: float = 0.5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g, c = generator, channels
        self.ca0 = Dense(c, c // 4, generator=g)
        self.drop_ca = Dropout(dropout)
        self.ca1 = Dense(c // 4, c, generator=g)
        self.sa0 = Dense(c, c // 4, generator=g)
        self.sa_bn = BatchNorm(c // 4)
        self.drop_sa = Dropout(dropout)
        self.sa1 = Dense(c // 4, 1, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ca = self.drop_ca(F.relu(self.ca0(x.mean(dim=1, keepdim=True))))
        x_ca = x * torch.sigmoid(self.ca1(ca))
        sa = self.drop_sa(F.relu(self.sa_bn(self.sa0(x_ca))))
        return x + x_ca * torch.sigmoid(self.sa1(sa))
