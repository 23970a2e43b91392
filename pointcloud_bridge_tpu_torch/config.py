"""Configuration of the port: the JAX package's config tree, shared rather
than copied. ``pointcloud_bridge_tpu/config.py`` is stdlib dataclasses and
imports ``yaml`` only inside ``Config.from_yaml``; importing it imports no
JAX."""

from pointcloud_bridge_tpu.config import (
    Config,
    DataConfig,
    LossConfig,
    ModelConfig,
    TrainConfig,
)

__all__ = ["Config", "DataConfig", "LossConfig", "ModelConfig", "TrainConfig"]
