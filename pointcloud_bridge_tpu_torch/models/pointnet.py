"""The PointNet segmentation family in PyTorch (counterpart of
pointcloud_bridge_tpu/models/pointnet.py): the transform regressor
:class:`TNet`, :class:`PointNetSeg` (``pointnet``, ``pointnet_seg``),
:class:`PointNetGlobalSeg` (``pointnet_global``) and
:class:`PointNetSemSegPartsize` (``pointnet_sem_seg``).

No Pallas kernel runs in these models: every layer is a per-point Dense,
a BatchNorm, a ReLU, a global max-pool (``torch.amax``) or a batched 3x3 or
64x64 transform (``torch.bmm``, the JAX package's ``bnk,bkj->bnj``).

Parameter names. ``pointnet`` and ``pointnet_sem_seg`` carry the reference
torch models' (Highway_bridge/models/pointnet.py, Partsize-identical/models/
pointnet_sem_seg.py), which the JAX package's ``_rules_pointnet`` and
``_rules_pointnet_sem_seg`` map (utils/torch_import.py:154, :362): their
per-point layers are Conv1d [O, I, 1], their T-Nets' fc layers Linear.
``pointnet_global`` has no reference torch model, so its layers are named
after the flax modules (``mlp64_dense0``, ``stn.fc3``), a Dense stored as
[out, in]. ``TNet(..., conv=Dense)`` is the flax-named flavour.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .common import BatchNorm, Dense, Dropout, PointConv, sync_batchnorms


def conv1d(in_ch: int, out_ch: int, generator: Optional[torch.Generator]) -> nn.Module:
    """The reference's kernel-size-1 Conv1d, stored [out, in, 1]."""
    return PointConv(in_ch, out_ch, 1, generator)


def dense(in_ch: int, out_ch: int, generator: Optional[torch.Generator]) -> nn.Module:
    """A flax-named Dense (or the reference's Linear), stored [out, in]."""
    return Dense(in_ch, out_ch, generator=generator)


class TNet(nn.Module):
    """Transform regressor (models/pointnet.py:23-47): shared MLP
    in_ch -> 64 -> 128 -> 1024 (``conv1``-``conv3`` with ``bn1``-``bn3``) ->
    max over the points -> FC 512, 256 (``fc1``, ``fc2`` with ``bn4``,
    ``bn5``, which normalise [B, 512] over the batch alone) -> ``fc3`` to
    k * k, plus the identity. forward(x [B, N, in_ch]) -> [B, k, k].
    ``conv`` builds the per-point layers: :func:`conv1d` under the
    reference's names, :func:`dense` under the flax ones."""

    def __init__(self, k: int = 3, in_ch: Optional[int] = None, conv=conv1d,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.k = k
        self.conv1 = conv(k if in_ch is None else in_ch, 64, g)
        self.conv2 = conv(64, 128, g)
        self.conv3 = conv(128, 1024, g)
        self.fc1 = dense(1024, 512, g)
        self.fc2 = dense(512, 256, g)
        self.fc3 = dense(256, k * k, g)
        for i, c in enumerate((64, 128, 1024, 512, 256), start=1):
            setattr(self, f"bn{i}", BatchNorm(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = F.relu(self.bn3(self.conv3(h)))
        g = torch.amax(h, dim=1)  # [B, 1024]
        g = F.relu(self.bn4(self.fc1(g)))
        g = F.relu(self.bn5(self.fc2(g)))
        eye = torch.eye(self.k, dtype=g.dtype, device=g.device).reshape(1, -1)
        return (self.fc3(g) + eye).reshape(-1, self.k, self.k)


class PointNetSeg(nn.Module):
    """PointNet semantic segmentation (models/pointnet.py:50-112): the input
    T-Net transforms xyz, which is then joined by the features; conv1, conv2
    (64, 64); the 64-d feature transform; conv3-conv5 (64, 128, 1024); the
    global max joined to each point's 64 features ([point 64 | global
    1024]); seg_conv1-3 (512, 256, 128) with BatchNorm and ReLU, dropout,
    seg_conv4. forward(xyz [B, N, 3], features [B, N, in_features] or None
    (xyz stands in), return_transform=False) -> logits [B, N, num_classes],
    and the 64-d transform with ``return_transform``."""

    def __init__(self, num_classes: int = 5, feature_transform: bool = True,
                 axis_name: Optional[str] = None, dropout_rate: float = 0.3,
                 in_features: int = 3, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.feature_transform = feature_transform
        self.input_transform = TNet(3, generator=g)
        widths = (3 + in_features, 64, 64, 64, 128, 1024)
        for i in range(1, 6):
            setattr(self, f"conv{i}", conv1d(widths[i - 1], widths[i], g))
            setattr(self, f"bn{i}", BatchNorm(widths[i]))
        if feature_transform:
            self.feature_transform_net = TNet(64, generator=g)
        widths = (64 + 1024, 512, 256, 128)
        for i in range(1, 4):
            setattr(self, f"seg_conv{i}", conv1d(widths[i - 1], widths[i], g))
            setattr(self, f"bn_seg{i}", BatchNorm(widths[i]))
        self.drop = Dropout(dropout_rate)
        self.seg_conv4 = conv1d(128, num_classes, g)
        sync_batchnorms(self, axis_name)

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor] = None,
                return_transform: bool = False):
        if features is None:
            features = xyz
        x = torch.cat([torch.bmm(xyz, self.input_transform(xyz)), features], dim=-1)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        trans_feat = None
        if self.feature_transform:
            trans_feat = self.feature_transform_net(x)
            x = torch.bmm(x, trans_feat)
        point_feat = x  # [B, N, 64]
        x = F.relu(self.bn3(self.conv3(x)))
        x = F.relu(self.bn4(self.conv4(x)))
        x = F.relu(self.bn5(self.conv5(x)))
        glob = torch.amax(x, dim=1, keepdim=True).expand(-1, x.shape[1], -1)
        x = torch.cat([point_feat, glob], dim=-1)  # [B, N, 1088]
        for i in range(1, 4):
            x = F.relu(getattr(self, f"bn_seg{i}")(getattr(self, f"seg_conv{i}")(x)))
        logits = self.seg_conv4(self.drop(x))
        return (logits, trans_feat) if return_transform else logits


class PointNetGlobalSeg(nn.Module):
    """Global-classification PointNet that repeats the scene's logits at
    every point (models/pointnet.py:115-157): the ``stn`` T-Net transforms
    xyz (the features are not read); conv1 (64); the shared two-layer
    refinement ``mlp64_dense0`` -> ``mlp64_bn`` -> ReLU -> ``mlp64_dense1``
    applied twice with the same weights (in train mode ``mlp64_bn`` updates
    its statistics twice a call, the second update from the first one's
    result, as flax does); conv2-conv5 (128, 256, 512, 2048); max; fc1, fc2
    (512, 256) with bn6, bn7; dropout; fc3. forward(xyz [B, N, 3],
    features or None) -> logits [B, N, num_classes]."""

    def __init__(self, num_classes: int = 5, axis_name: Optional[str] = None,
                 dropout_rate: float = 0.3, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.stn = TNet(3, conv=dense, generator=g)
        self.conv1 = dense(3, 64, g)
        self.bn1 = BatchNorm(64)
        self.mlp64_dense0 = dense(64, 64, g)
        self.mlp64_bn = BatchNorm(64)
        self.mlp64_dense1 = dense(64, 64, g)
        widths = (64, 128, 256, 512, 2048)
        for i in range(2, 6):
            setattr(self, f"conv{i}", dense(widths[i - 2], widths[i - 1], g))
            setattr(self, f"bn{i}", BatchNorm(widths[i - 1]))
        self.fc1 = dense(2048, 512, g)
        self.bn6 = BatchNorm(512)
        self.fc2 = dense(512, 256, g)
        self.bn7 = BatchNorm(256)
        self.drop = Dropout(dropout_rate)
        self.fc3 = dense(256, num_classes, g)
        sync_batchnorms(self, axis_name)

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = torch.bmm(xyz, self.stn(xyz))
        x = F.relu(self.bn1(self.conv1(x)))
        for _ in range(2):
            x = self.mlp64_dense1(F.relu(self.mlp64_bn(self.mlp64_dense0(x))))
        for i in range(2, 6):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        h = torch.amax(x, dim=1)  # [B, 2048]
        h = F.relu(self.bn6(self.fc1(h)))
        h = F.relu(self.bn7(self.fc2(h)))
        logits = self.fc3(self.drop(h))
        return logits.unsqueeze(1).expand(-1, xyz.shape[1], -1)


class _PartsizeEncoder(nn.Module):
    """The reference's PointNetEncoder (``feat``): ``stn``, ``fstn`` and
    ``conv1``-``conv3`` with ``bn1``-``bn3``."""

    def __init__(self, channels: int, generator: Optional[torch.Generator]):
        super().__init__()
        g = generator
        self.stn = TNet(3, channels, generator=g)
        self.fstn = TNet(64, generator=g)
        self.conv1 = conv1d(channels, 64, g)
        self.bn1 = BatchNorm(64)
        self.conv2 = conv1d(64, 128, g)
        self.bn2 = BatchNorm(128)
        self.conv3 = conv1d(128, 1024, g)
        self.bn3 = BatchNorm(1024)


class PointNetSemSegPartsize(nn.Module):
    """Partsize pointnet_sem_seg (models/pointnet.py:160-224): the ``stn``
    T-Net reads every channel of [xyz | features] but its 3x3 transforms
    the coordinates alone; conv1 (64); the 64-d ``fstn`` transform; conv2
    (128); conv3 (1024) with BatchNorm and no ReLU; the global max joined
    to each point's 64 features ([global 1024 | point 64]); the head conv1-3
    (512, 256, 128) with BatchNorm and ReLU, conv4. ``with_rgb`` False reads
    xyz alone. forward(xyz [B, N, 3], features [B, N, in_features],
    return_transform=False) -> logits [B, N, num_classes] (and the 64-d
    transform). ``in_features`` 3 by default, the colours the CLIs feed; 6
    for the Partsize columns beside xyz."""

    def __init__(self, num_classes: int = 5, with_rgb: bool = True,
                 axis_name: Optional[str] = None, in_features: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.with_rgb = with_rgb
        self.channels = 3 + in_features if with_rgb else 3
        self.feat = _PartsizeEncoder(self.channels, g)
        widths = (1024 + 64, 512, 256, 128)
        for i in range(1, 4):
            setattr(self, f"conv{i}", conv1d(widths[i - 1], widths[i], g))
            setattr(self, f"bn{i}", BatchNorm(widths[i]))
        self.conv4 = conv1d(128, num_classes, g)
        sync_batchnorms(self, axis_name)

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor] = None,
                return_transform: bool = False):
        pc = torch.cat([xyz, features], dim=-1) if self.with_rgb and features is not None else xyz
        if pc.shape[-1] != self.channels:
            raise ValueError(f"PointNetSemSegPartsize: built for {self.channels} channels, "
                             f"got {pc.shape[-1]}")
        f = self.feat
        x = torch.cat([torch.bmm(pc[..., :3], f.stn(pc)), pc[..., 3:]], dim=-1)
        x = F.relu(f.bn1(f.conv1(x)))
        trans_feat = f.fstn(x)
        x = torch.bmm(x, trans_feat)
        point_feat = x  # [B, N, 64]
        x = F.relu(f.bn2(f.conv2(x)))
        x = f.bn3(f.conv3(x))  # no ReLU (the reference's :138)
        glob = torch.amax(x, dim=1, keepdim=True).expand(-1, x.shape[1], -1)
        h = torch.cat([glob, point_feat], dim=-1)  # [B, N, 1088]
        for i in range(1, 4):
            h = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(h)))
        logits = self.conv4(h)
        return (logits, trans_feat) if return_transform else logits
