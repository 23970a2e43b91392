"""Models of the PyTorch port."""

from .attention import (
    BridgeStructureEncoding,
    ColorFeatureExtraction,
    CompositeFeatureFusion,
    GeometricFeatureExtraction,
    MultiScaleFeatureFusion,
)
from .bristrunet import BriStruNet
from .common import (
    BatchNorm,
    Dense,
    DenseMLP,
    Dropout,
    EnhancedFeaturePropagation,
    FeaturePropagation,
    MultiScaleSetAbstraction,
    PointConv,
    SegHead,
    SetAbstraction,
    SharedMLP,
)
from .pointnet2 import PointNet2SSG
from .registry import MODEL_REGISTRY, get_model

__all__ = [
    "BatchNorm",
    "BriStruNet",
    "BridgeStructureEncoding",
    "ColorFeatureExtraction",
    "CompositeFeatureFusion",
    "Dense",
    "DenseMLP",
    "Dropout",
    "EnhancedFeaturePropagation",
    "FeaturePropagation",
    "GeometricFeatureExtraction",
    "MODEL_REGISTRY",
    "MultiScaleFeatureFusion",
    "MultiScaleSetAbstraction",
    "PointConv",
    "PointNet2SSG",
    "SegHead",
    "SetAbstraction",
    "SharedMLP",
    "get_model",
]
