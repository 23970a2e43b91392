"""Shared building blocks of the PointNet++ models, in PyTorch.

Counterpart of pointcloud_bridge_tpu/models/common.py. The compute is
channel-last like the JAX package: a kernel-size-1 convolution of the
reference is ``F.linear`` over the last axis, BatchNorm normalises over
every axis but the channels, and the max over neighbours is ``torch.amax``.

Parameter names and shapes are the reference torch model's
(``sa1.mlp_convs.0.weight`` [64, 6, 1, 1], ``fp1.mlp_bns.2.running_var``,
``conv1``, ``bn1``, ``conv2``), so ``convert_state_dict`` of the JAX package
maps the port's weights to flax variables unchanged. To keep those names
flat, a set-abstraction or feature-propagation layer *is* a SharedMLP with
its sampling and grouping added, and a segmentation model *is* a SegHead
with its encoder and decoder added.

BatchNorm: momentum 0.1 and eps 1e-5, which is flax's momentum 0.9 and eps
1e-5 as the JAX package sets them.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import (
    farthest_point_sample,
    group_points,
    index_points,
    query_ball_point,
    three_nn_interpolate,
)


class PointConv(nn.Module):
    """The reference's kernel-size-1 Conv1d (kdims=1) or Conv2d (kdims=2),
    stored with its shape [out, in, 1(, 1)] and applied to channel-last
    input as ``F.linear``. Initialised as torch initialises a convolution,
    uniform in +-1/sqrt(in), from ``generator``."""

    def __init__(self, in_ch: int, out_ch: int, kdims: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((out_ch, in_ch) + (1,) * kdims))
        self.bias = nn.Parameter(torch.empty(out_ch))
        bound = 1.0 / math.sqrt(in_ch)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.flatten(1), self.bias)


def batch_norm_last(bn: nn.BatchNorm1d, x: torch.Tensor) -> torch.Tensor:
    """Apply a BatchNorm over the last axis of a channel-last tensor."""
    return bn(x.reshape(-1, x.shape[-1])).reshape(x.shape)


class SharedMLP(nn.Module):
    """Per-point conv + BatchNorm + ReLU stack over the last axis
    (models/common.py:30-60), parameters under ``mlp_convs.{i}`` and
    ``mlp_bns.{i}``."""

    def __init__(self, in_ch: int, widths: Sequence[int], kdims: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mlp_convs = nn.ModuleList()
        self.mlp_bns = nn.ModuleList()
        for w in widths:
            self.mlp_convs.append(PointConv(in_ch, w, kdims, generator))
            self.mlp_bns.append(nn.BatchNorm1d(w, eps=1e-5, momentum=0.1))
            in_ch = w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv, bn in zip(self.mlp_convs, self.mlp_bns):
            x = F.relu(batch_norm_last(bn, conv(x)))
        return x


class SetAbstraction(SharedMLP):
    """PointNet++ single-scale set abstraction (models/common.py:81-128):
    FPS -> ball query -> centre-relative grouping -> shared MLP -> max over
    the neighbours. features [B, N, C] or None -> ([B, npoint, 3],
    [B, npoint, mlp[-1]]). ``in_ch`` counts the 3 relative coordinates.
    Its convolutions are the reference's Conv2d."""

    def __init__(self, npoint: int, radius: float, nsample: int, in_ch: int,
                 mlp: Sequence[int], generator: Optional[torch.Generator] = None):
        super().__init__(in_ch, mlp, kdims=2, generator=generator)
        self.npoint = npoint
        self.radius = radius
        self.nsample = nsample

    def forward(
        self, xyz: torch.Tensor, features: Optional[torch.Tensor]
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        fps_idx = farthest_point_sample(xyz, self.npoint)
        new_xyz = index_points(xyz, fps_idx)
        idx = query_ball_point(self.radius, self.nsample, xyz, new_xyz)
        grouped = group_points(xyz, new_xyz, idx, features)  # [B,S,K,3+C]
        return new_xyz, torch.amax(super().forward(grouped), dim=2)


class FeaturePropagation(SharedMLP):
    """PointNet++ decoder layer (models/common.py:209-251): 3-NN
    inverse-distance interpolation of the coarse features onto the fine
    points, concatenated after the fine skip features, then a shared MLP.
    The coarse features are cast to float32 before interpolating, as in the
    JAX layer. Its convolutions are the reference's Conv1d."""

    def __init__(self, in_ch: int, mlp: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_ch, mlp, kdims=1, generator=generator)

    def forward(
        self,
        xyz_fine: torch.Tensor,
        xyz_coarse: torch.Tensor,
        feats_fine: Optional[torch.Tensor],
        feats_coarse: torch.Tensor,
    ) -> torch.Tensor:
        interp = three_nn_interpolate(
            xyz_fine, xyz_coarse, feats_coarse.float(), k=3
        )
        if feats_fine is not None:
            interp = torch.cat([feats_fine.float(), interp], dim=-1)
        return super().forward(interp)


class SegHead(nn.Module):
    """Per-point classification head (models/common.py:318-342):
    conv1 + bn1 + ReLU + dropout + conv2. Dropout acts only in train mode."""

    def __init__(self, in_ch: int, num_classes: int, hidden: int = 128,
                 dropout: float = 0.5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = PointConv(in_ch, hidden, 1, generator)
        self.bn1 = nn.BatchNorm1d(hidden, eps=1e-5, momentum=0.1)
        self.drop1 = nn.Dropout(dropout)
        self.conv2 = PointConv(hidden, num_classes, 1, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(batch_norm_last(self.bn1, self.conv1(x)))
        return self.conv2(self.drop1(x))
