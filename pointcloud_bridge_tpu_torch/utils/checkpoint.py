"""Checkpoints of the port (counterpart of
pointcloud_bridge_tpu/utils/checkpoint.py, which writes orbax trees).

A checkpoint is one ``torch.save`` file holding a dict: ``model`` (the
model's state_dict), ``optimizer`` (the optimizer's state_dict) and
``epoch``, plus ``val_acc`` for ``best_model``. A checkpoint without
``optimizer`` holds weights only: resuming from it is a warm start with a
fresh optimizer. The format is the port's own; it is not an orbax tree.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch


def save_checkpoint(path: str, state: Dict[str, Any]) -> None:
    """Write ``state`` to ``path`` through a temporary file, so that a
    reader never sees half a checkpoint."""
    path = os.path.abspath(path)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def restore_checkpoint(path: str, map_location="cpu") -> Dict[str, Any]:
    """Load a checkpoint written by ``save_checkpoint``."""
    return torch.load(os.path.abspath(path), map_location=map_location,
                      weights_only=True)
