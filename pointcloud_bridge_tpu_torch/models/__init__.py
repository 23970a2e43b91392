"""Models of the PyTorch port."""

from .attention import (
    BridgeStructureEncoding,
    ColorFeatureExtraction,
    CompositeFeatureFusion,
    GeometricFeatureExtraction,
    MultiScaleFeatureFusion,
)
from .bristrunet import BriStruNet
from .cls_models import PointNet2ClsMSG, PointNet2ClsSSG, PointNet2SSGPartsize
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
from .moe import MoEFeedForward, upcycle_dense_to_moe
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
    "PointTransformerBlock",
    "PointTransformerV3",
    "PointTransformerV3Pooled",
    "SegHead",
    "SerializedPool",
    "SerializedUnpool",
    "SetAbstraction",
    "SharedMLP",
    "get_model",
    "morton_code",
    "upcycle_dense_to_moe",
]
