"""The Partsize extras in PyTorch (counterpart of
pointcloud_bridge_tpu/models/cls_models.py): the 4-level SSG segmentation
model ``PointNet2SSGPartsize`` (``pointnet2_sem_seg``), the two PointNet++
classifiers ``PointNet2ClsSSG`` and ``PointNet2ClsMSG``, and the PointNet
classifier ``PointNetCls`` (``pointnet_cls``).

Parameter names are the reference torch models'
(Partsize-identical/models/pointnet2_sem_seg.py, pointnet2_cls_ssg.py,
pointnet2_cls_msg.py): ``sa{i}.mlp_convs.{j}`` and ``sa{i}.mlp_bns.{j}``
(Conv2d), ``sa{i}.conv_blocks.{b}.{j}`` and ``bn_blocks`` (an MSG level, its
first conv a branch in the reference's [features, rel-xyz] order),
``fp{i}.mlp_convs.{j}`` (Conv1d), the segmentation head's ``conv1``/``bn1``/
``conv2`` and the classifiers' ``fc1``-``fc3`` (Linear), ``bn1``, ``bn2``.

The classifiers return logits [B, num_classes] (the reference returns
log-probs). Their FC BatchNorms normalise over the batch alone; their
dropouts draw from the generator the trainer sets (common.Dropout).
``PointNetCls`` has no reference torch model here, so its layers carry the
flax module names (``stn``, ``fstn``, ``conv1``-``conv3``, ``bn1``-``bn5``,
``fc1``-``fc3``), a Dense stored as [out, in].
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .common import (
    BatchNorm,
    Dense,
    Dropout,
    FeaturePropagation,
    GroupAllAbstraction,
    MultiScaleSetAbstractionMsg,
    SegHead,
    SetAbstraction,
    sync_batchnorms,
)
from .pointnet import TNet, dense


class PointNet2SSGPartsize(SegHead):
    """Partsize pointnet2_sem_seg (pointnet2_sem_seg.py:7-47;
    cls_models.py:149-175): four SSG levels, (npoint, radius) 1024 / 0.1,
    256 / 0.2, 64 / 0.4, 16 / 0.8, K 32, widths (32, 32, 64), (64, 64, 128),
    (128, 128, 256), (256, 256, 512); FP (256, 256) twice, (256, 128),
    (128, 128, 128); a head of 128 with dropout 0.5.
    forward(xyz [B, N, 3], features [B, N, in_features] or None) -> logits
    [B, N, num_classes]. ``in_features`` as PointNet2MSG's: 3 for the
    colours the CLIs feed, 9 for the Partsize columns."""

    LEVELS = ((1024, 0.1, (32, 32, 64)), (256, 0.2, (64, 64, 128)),
              (64, 0.4, (128, 128, 256)), (16, 0.8, (256, 256, 512)))

    def __init__(self, num_classes: int = 5, in_features: int = 3,
                 axis_name: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(128, num_classes, 128, 0.5, generator)
        g, c = generator, in_features
        for i, (npoint, radius, mlp) in enumerate(self.LEVELS, start=1):
            setattr(self, f"sa{i}", SetAbstraction(npoint, radius, 32, 3 + c, mlp, g))
            c = mlp[-1]
        self.fp4 = FeaturePropagation(256 + 512, (256, 256), g)
        self.fp3 = FeaturePropagation(128 + 256, (256, 256), g)
        self.fp2 = FeaturePropagation(64 + 256, (256, 128), g)
        self.fp1 = FeaturePropagation(128, (128, 128, 128), g)
        sync_batchnorms(self, axis_name)

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor]) -> torch.Tensor:
        l1_xyz, l1 = self.sa1(xyz, features)
        l2_xyz, l2 = self.sa2(l1_xyz, l1)
        l3_xyz, l3 = self.sa3(l2_xyz, l2)
        l4_xyz, l4 = self.sa4(l3_xyz, l3)
        l3 = self.fp4(l3_xyz, l4_xyz, l3, l4)
        l2 = self.fp3(l2_xyz, l3_xyz, l2, l3)
        l1 = self.fp2(l1_xyz, l2_xyz, l1, l2)
        l0 = self.fp1(xyz, l1_xyz, None, l1)
        return super().forward(l0)


class _Classifier(nn.Module):
    """A PointNet++ classifier: set abstractions ``sa1`` and ``sa2`` ->
    ``sa3`` (group-all, widths 256, 512, 1024) -> ``fc1`` + ``bn1`` + ReLU ->
    dropout -> ``fc2`` + ``bn2`` + ReLU -> dropout -> ``fc3``.
    forward(xyz [B, N, 3], features [B, N, in_features] or None) -> logits
    [B, num_classes]. ``in_ch`` is the width of sa2's output."""

    def __init__(self, sa1: nn.Module, sa2: nn.Module, in_ch: int, num_classes: int,
                 dropout_rate: float, generator: Optional[torch.Generator]):
        super().__init__()
        g = generator
        self.sa1 = sa1
        self.sa2 = sa2
        self.sa3 = GroupAllAbstraction(3 + in_ch, (256, 512, 1024), g)
        self.fc1 = Dense(1024, 512, generator=g)
        self.bn1 = BatchNorm(512)
        self.drop1 = Dropout(dropout_rate)
        self.fc2 = Dense(512, 256, generator=g)
        self.bn2 = BatchNorm(256)
        self.drop2 = Dropout(dropout_rate)
        self.fc3 = Dense(256, num_classes, generator=g)

    def forward(self, xyz: torch.Tensor,
                features: Optional[torch.Tensor] = None) -> torch.Tensor:
        l1_xyz, l1 = self.sa1(xyz, features)
        l2_xyz, l2 = self.sa2(l1_xyz, l1)
        h = self.sa3(l2_xyz, l2)
        h = self.drop1(F.relu(self.bn1(self.fc1(h))))
        h = self.drop2(F.relu(self.bn2(self.fc2(h))))
        return self.fc3(h)


class PointNet2ClsSSG(_Classifier):
    """pointnet2_cls_ssg (cls_models.py:46-74): SA(512, 0.2, 32, (64, 64,
    128)), SA(128, 0.4, 64, (128, 128, 256)), group-all, the FC head.
    ``in_features`` 0 (the default) means xyz alone (``features`` None), as
    the JAX signature's default."""

    def __init__(self, num_classes: int = 5, in_features: int = 0,
                 dropout_rate: float = 0.4, axis_name: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        g = generator
        super().__init__(SetAbstraction(512, 0.2, 32, 3 + in_features, (64, 64, 128), g),
                         SetAbstraction(128, 0.4, 64, 3 + 128, (128, 128, 256), g),
                         256, num_classes, dropout_rate, g)
        sync_batchnorms(self, axis_name)


class PointNet2ClsMSG(_Classifier):
    """pointnet2_cls_msg (cls_models.py:77-106): sa1 512 centres, radii
    (0.1, 0.2, 0.4) with K (16, 32, 128); sa2 128 centres, (0.2, 0.4, 0.8)
    with K (32, 64, 128), the three radii of a level in one ball-query
    launch; group-all, the FC head. ``in_features`` as PointNet2ClsSSG's."""

    BRANCHES = (
        ((32, 32, 64), (64, 64, 128), (64, 96, 128)),
        ((64, 64, 128), (128, 128, 256), (128, 128, 256)),
    )

    def __init__(self, num_classes: int = 5, in_features: int = 0,
                 dropout_rate: float = 0.4, axis_name: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        g = generator
        super().__init__(
            MultiScaleSetAbstractionMsg(512, (0.1, 0.2, 0.4), (16, 32, 128),
                                        3 + in_features, self.BRANCHES[0], g),
            MultiScaleSetAbstractionMsg(128, (0.2, 0.4, 0.8), (32, 64, 128), 3 + 320,
                                        self.BRANCHES[1], g),
            640, num_classes, dropout_rate, g)
        sync_batchnorms(self, axis_name)


class PointNetCls(nn.Module):
    """pointnet_cls (cls_models.py:109-146): the ``stn`` T-Net transforms
    xyz, the features join after it; conv1 (64); the 64-d ``fstn``
    transform; conv2, conv3 (128, 1024); max over the points; fc1 (512)
    with bn4, dropout, fc2 (256) with bn5, fc3. forward(xyz [B, N, 3],
    features [B, N, in_features] or None, return_transform=False) -> logits
    [B, num_classes] (and the 64-d transform). ``in_features`` 0 (the
    default) means xyz alone, as PointNet2ClsSSG's."""

    def __init__(self, num_classes: int = 5, feature_transform: bool = True,
                 axis_name: Optional[str] = None, dropout_rate: float = 0.4,
                 in_features: int = 0, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.feature_transform = feature_transform
        self.stn = TNet(3, conv=dense, generator=g)
        self.conv1 = dense(3 + in_features, 64, g)
        self.bn1 = BatchNorm(64)
        if feature_transform:
            self.fstn = TNet(64, conv=dense, generator=g)
        self.conv2 = dense(64, 128, g)
        self.bn2 = BatchNorm(128)
        self.conv3 = dense(128, 1024, g)
        self.bn3 = BatchNorm(1024)
        self.fc1 = dense(1024, 512, g)
        self.bn4 = BatchNorm(512)
        self.drop = Dropout(dropout_rate)
        self.fc2 = dense(512, 256, g)
        self.bn5 = BatchNorm(256)
        self.fc3 = dense(256, num_classes, g)
        sync_batchnorms(self, axis_name)

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor] = None,
                return_transform: bool = False):
        x = torch.bmm(xyz, self.stn(xyz))
        if features is not None:
            x = torch.cat([x, features], dim=-1)
        x = F.relu(self.bn1(self.conv1(x)))
        trans_feat = None
        if self.feature_transform:
            trans_feat = self.fstn(x)
            x = torch.bmm(x, trans_feat)
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.relu(self.bn3(self.conv3(x)))
        h = torch.amax(x, dim=1)
        h = self.drop(F.relu(self.bn4(self.fc1(h))))
        h = F.relu(self.bn5(self.fc2(h)))
        logits = self.fc3(h)
        return (logits, trans_feat) if return_transform else logits
