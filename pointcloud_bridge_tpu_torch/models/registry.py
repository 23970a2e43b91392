"""Model registry of the port (counterpart of
pointcloud_bridge_tpu/models/registry.py): every name of the JAX
package's registry, each to the port's class of the same name."""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch
from torch import nn

from .bristrunet import BriStruNet
from .cls_models import PointNet2ClsMSG, PointNet2ClsSSG, PointNet2SSGPartsize, PointNetCls
from .dgcnn import DGCNN, DGCNNGlobal
from .enhanced_pointnet2 import EnhancedPointNet2SSG
from .pointnet import PointNetGlobalSeg, PointNetSeg, PointNetSemSegPartsize
from .pointnet2 import PointNet2MSG, PointNet2SSG
from .ptv3 import PointTransformerV3
from .ptv3_pooled import PointTransformerV3Pooled
from .randlanet import RandLANet, RandLANetSS
from .spg import SuperpointGraph
from .spt import SPTSegmenter

MODEL_REGISTRY = {
    "pointnet": PointNetSeg,  # eva_model's 'PointNet' (pointnet.py:59-173)
    "pointnet_seg": PointNetSeg,
    "pointnet_global": PointNetGlobalSeg,  # model.py:301-369 variant
    "pointnet_cls": PointNetCls,
    "pointnet_sem_seg": PointNetSemSegPartsize,  # Partsize 9-ch PointNet seg
    "pointnet2": PointNet2SSG,  # reference name for the SSG seg model
    "pointnet2_ssg": PointNet2SSG,
    "pointnet2_msg": PointNet2MSG,  # Partsize 9-channel MSG, the north star
    "pointnet2_sem_seg": PointNet2SSGPartsize,  # Partsize 4-level SSG seg
    "pointnet2_cls_ssg": PointNet2ClsSSG,
    "pointnet2_cls_msg": PointNet2ClsMSG,
    "bristrunet": BriStruNet,  # EnhancedPointNet2 / BridgeSeg (paper model)
    "enhanced_pointnet2": BriStruNet,
    "bridgeseg": BriStruNet,
    "enhanced_pointnet2_ssg": EnhancedPointNet2SSG,  # older SSG+EPE variant
    "ptv3": PointTransformerV3,  # the reference's flat transformer
    # every other block's feed-forward routes to 8 experts (models/moe.py)
    "ptv3_moe": partial(PointTransformerV3, num_experts=8),
    "ptv3_pooled": PointTransformerV3Pooled,  # serialized encoder-decoder
    "dgcnn": DGCNN,  # the k=20 segmentation model of configs/train_dgcnn.yaml
    "dgcnn_global": DGCNNGlobal,  # the k=64 variant, logits repeated per point
    "randlanet": RandLANet,
    "randlanet_ss": RandLANetSS,  # density sampling, re-weighted k-NN, one MLP a level
    "spg": SuperpointGraph,
    "superpoint_graph": SuperpointGraph,
    "spt": SPTSegmenter,  # point-level SuperPointTransformer wrapper
    "superpoint_transformer": SPTSegmenter,
}


def get_model(
    name: str,
    num_classes: int,
    device: torch.device | str = "cpu",
    generator: Optional[torch.Generator] = None,
    **kwargs,
) -> nn.Module:
    """Build ``name`` with weights drawn from ``generator`` (a CPU
    generator, or torch's default one when None) and move it to device."""
    if name not in MODEL_REGISTRY:
        raise ValueError(f"unknown model '{name}'; available: {sorted(MODEL_REGISTRY)}")
    model = MODEL_REGISTRY[name](
        num_classes=num_classes, generator=generator, **kwargs
    )
    return model.to(device)
