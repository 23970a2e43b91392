"""Training engine of the port (counterpart of pointcloud_bridge_tpu/train)."""

from .loop import (
    MultiEvalStep,
    MultiTrainStep,
    group_batches,
    make_eval_step,
    make_optimizer,
    make_train_step,
    set_lr,
    train,
)
from .schedules import ReduceLROnPlateau, cosine_lr, step_decay_lr

__all__ = [
    "MultiEvalStep",
    "MultiTrainStep",
    "ReduceLROnPlateau",
    "cosine_lr",
    "group_batches",
    "make_eval_step",
    "make_optimizer",
    "make_train_step",
    "set_lr",
    "step_decay_lr",
    "train",
]
