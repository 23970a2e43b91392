"""``enhanced_pointnet2_ssg`` in PyTorch (counterpart of
pointcloud_bridge_tpu/models/enhanced_pointnet2.py): the older
EnhancedPointNet2 variant, an EnhancedPositionalEncoding of xyz joined to
the features, then the SSG PointNet++ stack; with ``use_attention`` an
EnhancedAttentionModule after each set abstraction, and after the first a
GeometricFeatureExtraction and a BoundaryAwareModule too.

Parameter names: the SSG levels, decoder and head carry the reference
torch names as PointNet2SSG's (``sa1.mlp_convs.0``, ``fp3.mlp_convs.1``,
``conv1``, ``bn1``, ``conv2``); the encoding and the attention blocks the
flax modules' (``pos_encoding.rel_mlp0``, ``attention1.ca0``,
``boundary1.attn_bn``); utils/weights.py maps both onto the JAX tree.
"""

from __future__ import annotations

from typing import Optional

import torch

from .attention import (
    BoundaryAwareModule,
    EnhancedAttentionModule,
    EnhancedPositionalEncoding,
    GeometricFeatureExtraction,
)
from .common import FeaturePropagation, SegHead, SetAbstraction, sync_batchnorms


class EnhancedPointNet2SSG(SegHead):
    """EnhancedPointNet2 (models/enhanced_pointnet2.py:26-73).

    forward(xyz [B, N, 3], features [B, N, in_features] or None (xyz stands
    in)) -> logits [B, N, num_classes]. ``pos_encoding`` gives
    ``pos_channels`` channels (k = 16 set neighbours of every input point),
    so sa1 groups 3 + in_features + pos_channels channels; SA levels (0.1,
    32, (64, 64, 128)), (0.2, 32, (128, 128, 256)), (0.4, 32, (256, 256,
    512)) at ``sa_npoints`` centres; FP (256, 256), (256, 128), (128, 128,
    128); a head of 128 with dropout 0.5. The attention blocks' Dropouts
    are the JAX modules' (0.5), which the model does not expose, as the JAX
    model does not. ``in_features`` is 3, the colours both CLIs feed."""

    def __init__(self, num_classes: int = 8, pos_channels: int = 6,
                 use_attention: bool = False, axis_name: Optional[str] = None,
                 sa_npoints: tuple = (1024, 256, 64), in_features: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__(128, num_classes, 128, 0.5, generator)
        g = generator
        n1, n2, n3 = sa_npoints
        self.use_attention = use_attention
        self.pos_encoding = EnhancedPositionalEncoding(pos_channels, generator=g)
        self.sa1 = SetAbstraction(n1, 0.1, 32, 3 + in_features + pos_channels, (64, 64, 128), g)
        self.sa2 = SetAbstraction(n2, 0.2, 32, 3 + 128, (128, 128, 256), g)
        self.sa3 = SetAbstraction(n3, 0.4, 32, 3 + 256, (256, 256, 512), g)
        if use_attention:
            self.attention1 = EnhancedAttentionModule(128, generator=g)
            self.geometric1 = GeometricFeatureExtraction(128, generator=g)
            self.boundary1 = BoundaryAwareModule(128, 16, generator=g)
            self.attention2 = EnhancedAttentionModule(256, generator=g)
            self.attention3 = EnhancedAttentionModule(512, generator=g)
        self.fp3 = FeaturePropagation(256 + 512, (256, 256), g)
        self.fp2 = FeaturePropagation(128 + 256, (256, 128), g)
        self.fp1 = FeaturePropagation(128, (128, 128, 128), g)
        sync_batchnorms(self, axis_name)

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor] = None) -> torch.Tensor:
        if features is None:
            features = xyz
        points = torch.cat([features, self.pos_encoding(xyz)], dim=-1)
        l1_xyz, l1 = self.sa1(xyz, points)
        if self.use_attention:
            l1 = self.attention1(l1)
            l1 = self.geometric1(l1, l1_xyz)
            l1 = self.boundary1(l1, l1_xyz)
        l2_xyz, l2 = self.sa2(l1_xyz, l1)
        if self.use_attention:
            l2 = self.attention2(l2)
        l3_xyz, l3 = self.sa3(l2_xyz, l2)
        if self.use_attention:
            l3 = self.attention3(l3)
        l2 = self.fp3(l2_xyz, l3_xyz, l2, l3)
        l1 = self.fp2(l1_xyz, l2_xyz, l1, l2)
        l0 = self.fp1(xyz, l1_xyz, None, l1)
        return super().forward(l0)
