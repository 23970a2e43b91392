"""Model registry of the port (counterpart of
pointcloud_bridge_tpu/models/registry.py). Only the models ported so far are
known; ROADMAP.md lists the order in which the rest follow."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .pointnet2 import PointNet2SSG

MODEL_REGISTRY = {
    "pointnet2_ssg": PointNet2SSG,
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
        raise NotImplementedError(
            f"model '{name}' is not ported to PyTorch yet (ported: "
            f"{sorted(MODEL_REGISTRY)}); ROADMAP.md lists what comes next"
        )
    model = MODEL_REGISTRY[name](
        num_classes=num_classes, generator=generator, **kwargs
    )
    return model.to(device)
