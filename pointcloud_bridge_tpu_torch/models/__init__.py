"""Models of the PyTorch port."""

from .attention import (
    BoundaryAwareModule,
    BridgeStructureEncoding,
    ColorFeatureExtraction,
    CompositeFeatureFusion,
    EnhancedAttentionModule,
    EnhancedPositionalEncoding,
    GeometricFeatureExtraction,
    MultiScaleFeatureFusion,
    SinusoidalPositionalEncoding,
    StructuralAwareModule,
)
from .bristrunet import BriStruNet
from .cls_models import PointNet2ClsMSG, PointNet2ClsSSG, PointNet2SSGPartsize, PointNetCls
from .common import (
    BatchNorm,
    Dense,
    DenseMLP,
    Dropout,
    EnhancedFeaturePropagation,
    FeaturePropagation,
    GroupAllAbstraction,
    MultiScaleSetAbstraction,
    MultiScaleSetAbstractionMsg,
    PointConv,
    SegHead,
    SetAbstraction,
    SharedMLP,
)
from .dgcnn import DGCNN, DGCNNGlobal, EdgeConv
from .enhanced_pointnet2 import EnhancedPointNet2SSG
from .moe import MoEFeedForward, upcycle_dense_to_moe
from .pointnet import PointNetGlobalSeg, PointNetSeg, PointNetSemSegPartsize, TNet
from .pointnet2 import PointNet2MSG, PointNet2SSG
from .ptv3 import (
    GEGLU,
    FeedForward,
    PointAttention,
    PointTransformerBlock,
    PointTransformerV3,
    morton_code,
)
from .ptv3_pooled import PointTransformerV3Pooled, SerializedPool, SerializedUnpool
from .registry import MODEL_REGISTRY, get_model

__all__ = [
    "BatchNorm",
    "BoundaryAwareModule",
    "BriStruNet",
    "BridgeStructureEncoding",
    "ColorFeatureExtraction",
    "CompositeFeatureFusion",
    "DGCNN",
    "DGCNNGlobal",
    "Dense",
    "DenseMLP",
    "Dropout",
    "EdgeConv",
    "EnhancedAttentionModule",
    "EnhancedPointNet2SSG",
    "EnhancedPositionalEncoding",
    "EnhancedFeaturePropagation",
    "FeaturePropagation",
    "FeedForward",
    "GEGLU",
    "GeometricFeatureExtraction",
    "MoEFeedForward",
    "GroupAllAbstraction",
    "MODEL_REGISTRY",
    "MultiScaleFeatureFusion",
    "MultiScaleSetAbstraction",
    "MultiScaleSetAbstractionMsg",
    "PointAttention",
    "PointConv",
    "PointNet2ClsMSG",
    "PointNet2ClsSSG",
    "PointNet2MSG",
    "PointNet2SSG",
    "PointNet2SSGPartsize",
    "PointNetCls",
    "PointNetGlobalSeg",
    "PointNetSeg",
    "PointNetSemSegPartsize",
    "PointTransformerBlock",
    "PointTransformerV3",
    "PointTransformerV3Pooled",
    "SegHead",
    "SerializedPool",
    "SerializedUnpool",
    "SetAbstraction",
    "SharedMLP",
    "SinusoidalPositionalEncoding",
    "StructuralAwareModule",
    "TNet",
    "get_model",
    "morton_code",
    "upcycle_dense_to_moe",
]
