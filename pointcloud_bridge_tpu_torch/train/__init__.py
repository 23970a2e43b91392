"""Training engine of the port (counterpart of pointcloud_bridge_tpu/train)."""

from .loop import (
    make_eval_step,
    make_optimizer,
    make_train_step,
    train,
)
from .schedules import ReduceLROnPlateau, cosine_lr, step_decay_lr

__all__ = [
    "ReduceLROnPlateau",
    "cosine_lr",
    "make_eval_step",
    "make_optimizer",
    "make_train_step",
    "step_decay_lr",
    "train",
]
