"""DGCNN, the dynamic-graph CNN, in PyTorch (counterpart of
pointcloud_bridge_tpu/models/dgcnn.py).

Four EdgeConv stages, each over a k-NN graph rebuilt from the current
features (xyz for the first, 64-channel features for the others), then a
1024-wide global feature: :class:`DGCNN` (``dgcnn``, k = 20) is the
segmentation model of configs/train_dgcnn.yaml, with a per-point head over
[local 320 | global 1024]; :class:`DGCNNGlobal` (``dgcnn_global``, k = 64)
pools [max | mean] and repeats its logits per point. Only xyz enters either
model. The graphs run on the k-NN kernels, K5 over xyz and K5c over
features; on the card the EdgeConvs' reductions run on K7 (and K7b).

Parameter names are the reference torch models' (utils/torch_import.py of
the JAX package, ``_rules_dgcnn`` and ``_rules_dgcnn_global``): an EdgeConv's
bias-free Conv2d is ``conv{i}.0`` and its BatchNorm ``bn{i}`` (the
reference registers the BatchNorm both standalone and inside its
Sequential; the port keeps the standalone name), ``conv5.0``, ``bn5``,
``local_bn``, ``point_conv.{0,1,3,4,6}``, ``linear{1,2,3}``, ``bn6``,
``bn7``.

EdgeConv has the JAX package's two forms, which compute the same function
on the same parameters: the literal one (the [B, N, k, 2C] graph feature,
Dense, BatchNorm, LeakyReLU(0.2), max over the neighbours) and the
restructured one, which projects before the gather and recovers the
BatchNorm from moments (``_MomentBN`` there, ``BatchNorm.
affine_from_moments`` here). As the JAX package runs the restructured form
on its accelerator and the literal one on the CPU, the port runs it on the
card (``_edgeconv_fast_default``: ``PCB_EDGECONV_FAST`` where set, with the
JAX package's values, else whether the input is a CUDA tensor). Not
ported: ``graph_recall`` (an ``approx_max_k`` knob; the port's k-NN is
exact, so the argument is not accepted). ``axis_name`` syncs every
BatchNorm over that mesh axis (``sync_batchnorms``), in either form.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import edge_conv_graph_feature, edge_reduce, knn, knn_set
from .common import BatchNorm, Dense, Dropout, PointConv, linear, sync_batchnorms

SLOPE = 0.2  # LeakyReLU's negative slope, the reference's


def _edgeconv_fast_default(x: torch.Tensor) -> bool:
    """Whether EdgeConv takes the restructured form (models/dgcnn.py:23-31
    of the JAX package): ``PCB_EDGECONV_FAST`` where it is set (off for
    "0", "false" and ""), else on a CUDA tensor, the counterpart of JAX's
    ``jax.default_backend() == "tpu"``."""
    flag = os.environ.get("PCB_EDGECONV_FAST")
    if flag is not None:
        return flag not in ("0", "false", "")
    return x.is_cuda


class EdgeConv(nn.Module):
    """One EdgeConv (models/dgcnn.py:73-140) over the graph of x's k nearest
    neighbours, k = min(k, N - 1) as the JAX models clamp it -> [B, N, F].
    The bias-free Conv2d ``0`` [F, 2C, 1, 1] has its columns [0:C] on
    x_j - x_i and [C:2C] on x_i. The BatchNorm is its model's ``bn{i}``,
    handed in at the call, since the reference registers it under that
    name.

    Literal form: ``knn`` -> (x_j - x_i, x_i) [B, N, k, 2C] -> the conv ->
    BatchNorm -> LeakyReLU(0.2) -> max over the neighbours.

    Restructured form (``_edgeconv_fast_default``): h_j = y_j + z_i with
    y = x W_a and z = x (W_b - W_a), W_a = W[:, :C], W_b = W[:, C:], so
    that BatchNorm and LeakyReLU, monotone a channel, commute with the max:
    LeakyReLU(a * (where(a > 0, max_j y_j, min_j y_j) + z) + c) with (a, c)
    the BatchNorm's affine (``affine_from_moments``). The graph comes from
    ``knn_set``; ``edge_reduce`` takes the max and the min (and, in train
    mode, the neighbour means of y and y^2, from which the batch moments of
    h follow) without building [B, N, k, F]: K7 on the card."""

    def __init__(self, in_ch: int, features: int, k: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.k = k
        self.add_module("0", PointConv(2 * in_ch, features, 2, generator, bias=False))

    def forward(self, x: torch.Tensor, bn: BatchNorm) -> torch.Tensor:
        k = min(self.k, x.shape[1] - 1)
        conv = getattr(self, "0")
        if not _edgeconv_fast_default(x):
            h = conv(edge_conv_graph_feature(x, idx=knn(x, k=k)))
            return torch.amax(F.leaky_relu(bn(h), SLOPE), dim=2)
        idx = knn_set(x, k=k)
        w, c = conv.weight.flatten(1), x.shape[-1]
        y = linear(x, w[:, :c], None, conv.column_group).contiguous()
        z = linear(x, w[:, c:] - w[:, :c], None, conv.column_group)
        if bn.training:
            mx, mn, s1, s2 = edge_reduce(y, idx, moments=True)
            mu = s1.mean(dim=(0, 1)) + z.mean(dim=(0, 1))
            mean2 = (s2.mean(dim=(0, 1)) + 2.0 * (z * s1).mean(dim=(0, 1))
                     + (z * z).mean(dim=(0, 1)))
            a, shift = bn.affine_from_moments(mu, mean2)
        else:
            mx, mn = edge_reduce(y, idx)
            a, shift = bn.affine_from_moments(None, None)
        return F.leaky_relu(a * (torch.where(a > 0, mx, mn) + z) + shift, SLOPE)


class _EdgeConvTrunk(nn.Module):
    """The four EdgeConvs (64/64/64/128) and ``conv5.0`` (320 -> 1024,
    bias-free) with their BatchNorms ``bn1``-``bn5``, shared by both models."""

    WIDTHS = (64, 64, 64, 128)

    def __init__(self, k: int, generator: Optional[torch.Generator]):
        super().__init__()
        in_ch = 3
        for i, width in enumerate(self.WIDTHS, start=1):
            setattr(self, f"conv{i}", EdgeConv(in_ch, width, k, generator))
            setattr(self, f"bn{i}", BatchNorm(width))
            in_ch = width
        self.conv5 = nn.Sequential(PointConv(sum(self.WIDTHS), 1024, 1, generator, bias=False))
        self.bn5 = BatchNorm(1024)

    def edge_features(self, xyz: torch.Tensor) -> torch.Tensor:
        """[B, N, 3] -> the four stages' outputs concatenated, [B, N, 320]."""
        x, stages = xyz, []
        for i in range(1, len(self.WIDTHS) + 1):
            x = getattr(self, f"conv{i}")(x, getattr(self, f"bn{i}"))
            stages.append(x)
        return torch.cat(stages, dim=-1)

    def global_features(self, local: torch.Tensor) -> torch.Tensor:
        """conv5 + bn5 + LeakyReLU: [B, N, 320] -> [B, N, 1024]."""
        return F.leaky_relu(self.bn5(self.conv5(local)), SLOPE)


class DGCNN(_EdgeConvTrunk):
    """The k = 20 segmentation DGCNN (models/dgcnn.py:143-185):
    forward(xyz [B, N, 3], features (ignored)) -> logits [B, N, num_classes].
    [local 320 after ``local_bn`` | global max 1024] -> ``point_conv``: 512,
    256 (BatchNorm, LeakyReLU each) -> num_classes."""

    def __init__(self, num_classes: int = 5, k: int = 20, axis_name: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(k, generator)
        g = generator
        self.local_bn = BatchNorm(320)
        self.point_conv = nn.Sequential(
            PointConv(1344, 512, 1, g), BatchNorm(512), nn.LeakyReLU(SLOPE),
            PointConv(512, 256, 1, g), BatchNorm(256), nn.LeakyReLU(SLOPE),
            PointConv(256, num_classes, 1, g),
        )
        sync_batchnorms(self, axis_name)

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor] = None) -> torch.Tensor:
        local = self.edge_features(xyz)
        local_n = F.leaky_relu(self.local_bn(local), SLOPE)
        g = self.global_features(local).amax(dim=1, keepdim=True)  # [B, 1, 1024]
        x = torch.cat([local_n, g.expand(-1, xyz.shape[1], -1)], dim=-1)  # [B, N, 1344]
        return self.point_conv(x)


class DGCNNGlobal(_EdgeConvTrunk):
    """The classification-style DGCNN (models/dgcnn.py:188-241, k = 64):
    forward(xyz [B, N, 3], features (ignored)) -> logits [B, N, num_classes],
    one row per cloud repeated per point. [max | mean] over the points
    (2048) -> ``linear1`` (bias-free) + ``bn6`` -> Dropout -> ``linear2`` +
    ``bn7`` -> Dropout -> ``linear3``; LeakyReLU(0.2) after each BatchNorm.
    The Dropouts draw from the generator the trainer sets (common.Dropout)."""

    def __init__(self, num_classes: int = 5, k: int = 64, axis_name: Optional[str] = None,
                 dropout_rate: float = 0.5, generator: Optional[torch.Generator] = None):
        super().__init__(k, generator)
        g = generator
        self.linear1 = Dense(2048, 512, bias=False, generator=g)
        self.bn6 = BatchNorm(512)
        self.dp1 = Dropout(dropout_rate)
        self.linear2 = Dense(512, 256, generator=g)
        self.bn7 = BatchNorm(256)
        self.dp2 = Dropout(dropout_rate)
        self.linear3 = Dense(256, num_classes, generator=g)
        sync_batchnorms(self, axis_name)

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.global_features(self.edge_features(xyz))
        g = torch.cat([x.amax(dim=1), x.mean(dim=1)], dim=-1)  # [B, 2048]
        g = self.dp1(F.leaky_relu(self.bn6(self.linear1(g)), SLOPE))
        g = self.dp2(F.leaky_relu(self.bn7(self.linear2(g)), SLOPE))
        logits = self.linear3(g)
        return logits.unsqueeze(1).expand(-1, xyz.shape[1], -1)
