"""Learning-rate schedules of the reference trainers (counterpart of
pointcloud_bridge_tpu/train/schedules.py, copied because that module's
package imports JAX):
  - ReduceLROnPlateau(mode=max, factor=0.1, patience=5), host-side;
  - cosine annealing;
  - step decay lr*0.7^(epoch//10) floored at 1e-5.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class ReduceLROnPlateau:
    """Host-side plateau scheduler on a maximized metric (val accuracy)."""

    lr: float
    factor: float = 0.1
    patience: int = 5
    min_lr: float = 1e-5
    best: float = float("-inf")
    bad_epochs: int = 0

    def step(self, metric: float) -> float:
        if metric > self.best:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad_epochs = 0
        return self.lr


def cosine_lr(base_lr: float, epoch: int, total_epochs: int, min_lr: float = 0.0) -> float:
    import math

    t = min(epoch / max(total_epochs, 1), 1.0)
    return min_lr + 0.5 * (base_lr - min_lr) * (1 + math.cos(math.pi * t))


def step_decay_lr(
    base_lr: float, epoch: int, decay: float = 0.7, every: int = 10, floor: float = 1e-5
) -> float:
    return max(base_lr * (decay ** (epoch // every)), floor)
