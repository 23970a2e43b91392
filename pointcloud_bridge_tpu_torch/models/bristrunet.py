"""BriStruNet / EnhancedPointNet2, the paper's model (counterpart of
pointcloud_bridge_tpu/models/bristrunet.py).

Pipeline: BridgeStructureEncoding (3 channels, k = 32) +
ColorFeatureExtraction (6 channels) -> CompositeFeatureFusion (-> 3
channels) -> 3 x MultiScaleSetAbstraction (1024/512/128 points, two radii,
one width list a level) with GeometricFeatureExtraction at levels 2 and 3
-> 3 x EnhancedFeaturePropagation -> MultiScaleFeatureFusion -> head.
Parameter names are the flax module names of the JAX model
(``bri_enc.mlp0_shared``, ``sa1.mlp_0.dense_0``, ``fp3.attn_dense0``,
``fusion.conv0``, ``final0``).

``sp_axis`` (JAX bristrunet.py:36-110): the inputs arrive whole on every
rank; the structure encoding's k-NN and statistics, the set abstractions'
ball queries, groupings and MLPs, the geometric blocks, the
feature-propagation layers, the multi-scale fusion and the head run on
this rank's slices of the points, gathered between levels, and the logits
are gathered once. FPS and the cheap colour and fusion stages run whole on
every rank. N and every ``sa_npoints`` entry must divide over the axis.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .attention import (
    BridgeStructureEncoding,
    ColorFeatureExtraction,
    CompositeFeatureFusion,
    GeometricFeatureExtraction,
    MultiScaleFeatureFusion,
)
from ..utils.collectives import all_gather
from .common import (
    BatchNorm,
    Dense,
    Dropout,
    EnhancedFeaturePropagation,
    MultiScaleSetAbstraction,
    sync_batchnorms,
)


class BriStruNet(nn.Module):
    """forward(xyz [B, N, 3], features [B, N, 3] rgb, or None for xyz) ->
    logits [B, N, num_classes], float32. ``sa_npoints`` shrinks the SA
    levels for tests. ``axis_name`` syncs every BatchNorm over that mesh
    axis. On CUDA it expects full float32 matmuls, as PointNet2SSG does."""

    def __init__(
        self,
        num_classes: int = 5,
        input_ch: int = 3,
        sa_npoints: tuple = (1024, 512, 128),
        dropout_rate: float = 0.5,
        generator: Optional[torch.Generator] = None,
        axis_name: Optional[str] = None,
        sp_axis: Optional[str] = None,
    ):
        super().__init__()
        g, sp = generator, sp_axis
        self.sp_axis = sp
        n1, n2, n3 = sa_npoints
        self.bri_enc = BridgeStructureEncoding(input_ch, 32, 4, generator=g, sp_axis=sp)
        self.color_encoder = ColorFeatureExtraction(6, 3, g)
        self.feature_fusion = CompositeFeatureFusion(input_ch + 6, input_ch, g)

        self.sa1 = MultiScaleSetAbstraction(
            n1, (0.1, 0.2), (16, 32), 3 + input_ch, (64, 64, 128), g, sp)
        self.sa2 = MultiScaleSetAbstraction(
            n2, (0.2, 0.4), (16, 32), 3 + 256, (128, 128, 256), g, sp)
        self.geometric2 = GeometricFeatureExtraction(512, g, sp)
        self.sa3 = MultiScaleSetAbstraction(
            n3, (0.4, 0.8), (16, 32), 3 + 512, (256, 256, 512), g, sp)
        self.geometric3 = GeometricFeatureExtraction(1024, g, sp)

        self.fp3 = EnhancedFeaturePropagation(512 + 1024, (1024, 256), g, sp)
        self.fp2 = EnhancedFeaturePropagation(256 + 256, (256, 256), g, sp)
        self.fp1 = EnhancedFeaturePropagation(input_ch + 256, (256, 128), g, sp,
                                              sp_gather=False)
        self.fusion = MultiScaleFeatureFusion((256, 256, 128), 128, g, sp)

        self.final0 = Dense(384, 128, generator=g)
        self.final_bn = BatchNorm(128)
        self.final_drop = Dropout(dropout_rate)
        self.final1 = Dense(128, num_classes, generator=g)
        sync_batchnorms(self, axis_name)

    def forward(
        self, xyz: torch.Tensor, features: Optional[torch.Tensor]
    ) -> torch.Tensor:
        if features is None:
            features = xyz
        fused = self.feature_fusion(self.bri_enc(xyz), self.color_encoder(features))

        l1_xyz, l1 = self.sa1(xyz, fused)  # [B, n1, 256]
        l2_xyz, l2 = self.sa2(l1_xyz, l1)  # [B, n2, 512]
        l2 = self.geometric2(l2, l2_xyz)
        l3_xyz, l3 = self.sa3(l2_xyz, l2)  # [B, n3, 1024]
        l3 = self.geometric3(l3, l3_xyz)

        l2 = self.fp3(l2_xyz, l3_xyz, l2, l3)
        l1 = self.fp2(l1_xyz, l2_xyz, l1, l2)
        l0 = self.fp1(xyz, l1_xyz, fused, l1)

        h = self.fusion([l2, l1, l0])  # [B, N, 384]
        h = F.relu(self.final_bn(self.final0(h)))
        logits = self.final1(self.final_drop(h))
        return all_gather(logits, self.sp_axis) if self.sp_axis else logits
