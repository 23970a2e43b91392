"""DGCNN, the dynamic-graph CNN, in PyTorch (counterpart of
pointcloud_bridge_tpu/models/dgcnn.py).

Four EdgeConv stages, each over a k-NN graph rebuilt from the current
features (xyz for the first, 64-channel features for the others), then a
1024-wide global feature: :class:`DGCNN` (``dgcnn``, k = 20) is the
segmentation model of configs/train_dgcnn.yaml, with a per-point head over
[local 320 | global 1024]; :class:`DGCNNGlobal` (``dgcnn_global``, k = 64)
pools [max | mean] and repeats its logits per point. Only xyz enters either
model. The graphs run on the k-NN kernels: K5 over xyz, K5c over features.

Parameter names are the reference torch models' (utils/torch_import.py of
the JAX package, ``_rules_dgcnn`` and ``_rules_dgcnn_global``): an EdgeConv's
bias-free Conv2d is ``conv{i}.0`` and its BatchNorm ``bn{i}`` (the
reference registers the BatchNorm both standalone and inside its
Sequential; the port keeps the standalone name), ``conv5.0``, ``bn5``,
``local_bn``, ``point_conv.{0,1,3,4,6}``, ``linear{1,2,3}``, ``bn6``,
``bn7``.

EdgeConv is the literal form that the JAX package runs off the TPU
(``_edgeconv_fast_default`` is False there): the [B, N, k, 2C] graph
feature, Dense, BatchNorm, LeakyReLU(0.2), max over the neighbours. The
restructured form with ``_MomentBN`` (project before the gather) is queued
in ROADMAP.md. Not ported: ``graph_recall`` (an ``approx_max_k`` knob; the
port's k-NN is exact, so the argument is not accepted). ``axis_name``
syncs every BatchNorm over that mesh axis (``sync_batchnorms``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import edge_conv_graph_feature, knn
from .common import BatchNorm, Dense, Dropout, PointConv, sync_batchnorms

SLOPE = 0.2  # LeakyReLU's negative slope, the reference's


class EdgeConv(nn.Module):
    """One EdgeConv (models/dgcnn.py:73-140, the literal path): graph
    ``knn(x, k)`` with k = min(k, N - 1), as the JAX models clamp it ->
    (x_j - x_i, x_i) [B, N, k, 2C] -> bias-free Conv2d ``0`` [F, 2C, 1, 1]
    -> BatchNorm -> LeakyReLU(0.2) -> max over the k neighbours -> [B, N, F].
    The BatchNorm is its model's ``bn{i}``, handed in at the call, since the
    reference registers it under that name."""

    def __init__(self, in_ch: int, features: int, k: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.k = k
        self.add_module("0", PointConv(2 * in_ch, features, 2, generator, bias=False))

    def forward(self, x: torch.Tensor, bn: BatchNorm) -> torch.Tensor:
        idx = knn(x, k=min(self.k, x.shape[1] - 1))
        h = getattr(self, "0")(edge_conv_graph_feature(x, idx=idx))
        return torch.amax(F.leaky_relu(bn(h), SLOPE), dim=2)


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
