"""Models of the PyTorch port."""

from .common import (
    FeaturePropagation,
    PointConv,
    SegHead,
    SetAbstraction,
    SharedMLP,
)
from .pointnet2 import PointNet2SSG
from .registry import MODEL_REGISTRY, get_model

__all__ = [
    "FeaturePropagation",
    "MODEL_REGISTRY",
    "PointConv",
    "PointNet2SSG",
    "SegHead",
    "SetAbstraction",
    "SharedMLP",
    "get_model",
]
