"""Attention and encoding modules of BriStruNet (counterpart of
pointcloud_bridge_tpu/models/attention.py), channel-last, with the flax
modules' names for every layer.

Ported are the five modules BriStruNet uses. The five others of the JAX
file (SinusoidalPositionalEncoding, EnhancedPositionalEncoding,
BoundaryAwareModule, and the two attention blocks of
``enhanced_pointnet2_ssg``) follow with that model (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.structure import knn_relative_positions, local_structure_features
from .common import BatchNorm, Dense


class BridgeStructureEncoding(nn.Module):
    """Grid-quantised absolute sin/cos encoding, k-NN relative positions and
    the 13-dim local structure statistics -> per-neighbour MLP -> max over
    the k neighbours (models/attention.py:49-110). [B, N, 3] -> [B, N,
    channels].

    The first Dense of the reference acts on [abs_enc | rel_pos | struct]
    per neighbour; abs_enc and struct are the same for all k neighbours, so
    it is split into ``mlp0_shared`` on [B, N, 6F + 13] (no bias) and
    ``mlp0_rel`` on the 3 relative coordinates, as in the JAX module. The
    BatchNorm runs over the 4-D [B, N, k, C] tensor.
    """

    def __init__(self, channels: int = 32, k_neighbors: int = 16,
                 freq_bands: int = 4, grid_size: float = 1.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
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
        grid_xyz = torch.floor(xyz / self.grid_size) * self.grid_size
        abs_enc = []
        for band in range(self.freq_bands):
            f = float(2 ** band)
            abs_enc.append(torch.sin(grid_xyz * f))
            abs_enc.append(torch.cos(grid_xyz * f))

        # the neighbours feed order-free statistics and a max-pooled MLP
        rel_pos, _ = knn_relative_positions(xyz, k, ordered=False)
        struct = local_structure_features(rel_pos)  # [B, N, 13]

        shared = self.mlp0_shared(torch.cat(abs_enc + [struct], dim=-1))
        h = shared.unsqueeze(2) + self.mlp0_rel(rel_pos)  # [B, N, k, C]
        h = self.mlp1(F.relu(self.bn0(h)))
        return torch.amax(h, dim=2)


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
    [B, N, C] -> [B, N, C]."""

    def __init__(self, channels: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.br_pos = BridgeStructureEncoding(16, generator=generator)
        self.mlp0 = Dense(channels + 16, channels, generator=generator)
        self.bn0 = BatchNorm(channels)
        self.mlp1 = Dense(channels, channels, generator=generator)

    def forward(self, x: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
        h = torch.cat([x, self.br_pos(xyz)], dim=-1)
        return self.mlp1(F.relu(self.bn0(self.mlp0(h))))


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
    (models/attention.py:311-345)."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 128,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.scales = len(in_channels)
        for i, c in enumerate(in_channels):
            setattr(self, f"conv{i}", Dense(c, out_channels, generator=generator))
            setattr(self, f"bn{i}", BatchNorm(out_channels))

    def forward(self, features_list: Sequence[torch.Tensor]) -> torch.Tensor:
        n = features_list[-1].shape[1]
        outs = []
        for i, feat in enumerate(features_list):
            h = getattr(self, f"conv{i}")(resize_nearest(feat, n))
            outs.append(F.relu(getattr(self, f"bn{i}")(h)))
        return torch.cat(outs, dim=-1)
