"""Data-parallel train and eval steps over the "data" axis of a mesh
(counterpart of pointcloud_bridge_tpu/parallel/train_step.py).

Every rank runs the single-device body on its rows of the batch, with the
model built with ``axis_name="data"``: its BatchNorms take their
statistics over the whole batch (sync-BN, models/common.py). The JAX step
runs under ``shard_map`` and takes the mean over ranks of the gradients,
the loss, the BatchNorm statistics and the accuracy (train_step.py:51-61);
so does this one, after the backward, in two all-reduces: one flat bucket
of every gradient, one of the loss, the accuracy and the float buffers.
The loss is the mean of the ranks' losses, which with class weights is not
the weighted loss of the global batch when the ranks' label mixes differ:
the JAX dp step's definition, kept. Parameters and optimizer state are
replicated (:func:`~.mesh.replicate`); a rank's Dropout generators must
differ from the others', as the JAX step folds the rank into its key
(``rank_seed``, which the trainer uses).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..train.loop import MultiTrainStep, loss_fn_for, make_eval_step, set_lr

_GOLDEN = 0x9E3779B97F4A7C15


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s generators: ``seed`` itself at rank 0, so
    that a world of one draws what the single-device trainer draws, and
    apart by a 64-bit odd constant a rank elsewhere."""
    return (seed + rank * _GOLDEN) % (1 << 63)


def all_reduce_bucket_(tensors: Sequence[torch.Tensor], group: Any, mean: bool = True) -> None:
    """The sum over ``group`` of each tensor, or with ``mean`` its mean, in
    place, through one flat all-reduce of their concatenation. At a world
    of one it changes no bit (a sum over one rank, a division by one)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    if mean:
        flat.div_(dist.get_world_size(group))
    parts = flat.split([t.numel() for t in tensors])
    torch._foreach_copy_(list(tensors), [p.view_as(t) for p, t in zip(parts, tensors)])


def gradients(model: torch.nn.Module) -> list:
    """Every parameter's gradient, a zero one where the backward left none
    (as JAX's gradient holds zeros), so that the ranks' buckets agree."""
    out = []
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        out.append(p.grad)
    return out


def dp_step_body(model: torch.nn.Module, loss_cfg, optimizer, mesh: DeviceMesh,
                 axis: str = "data") -> Callable:
    """``body(batch, class_weights) -> {"loss", "acc"}``: one data-parallel
    optimizer step on this rank's rows, the lr already set. Shared by
    :func:`make_dp_train_step` and :func:`make_dp_multi_train_step`, whose
    K steps are K of exactly this."""
    loss_fn = loss_fn_for(loss_cfg)
    group = mesh.get_group(axis)
    buffers = [b for b in model.buffers() if b.is_floating_point()]

    def body(batch, class_weights) -> Dict[str, torch.Tensor]:
        model.train()
        xyz, colors, labels = batch["points"], batch["colors"], batch["labels"]
        optimizer.zero_grad(set_to_none=True)
        logits = model(xyz, colors)
        loss = loss_fn(logits, labels, xyz, class_weights)
        loss.backward()
        with torch.no_grad():
            all_reduce_bucket_(gradients(model), group)
            metrics = torch.stack([loss.detach(), (logits.argmax(-1) == labels).float().mean()])
            all_reduce_bucket_([metrics] + buffers, group)
        optimizer.step()
        return {"loss": metrics[0], "acc": metrics[1]}

    return body


def make_dp_train_step(model: torch.nn.Module, loss_cfg, optimizer, mesh: DeviceMesh,
                       axis: str = "data") -> Callable:
    """``step(batch, lr, class_weights) -> {"loss", "acc"}`` on this rank's
    rows (:func:`~.mesh.shard_batch`). ``model`` must be built with
    ``axis_name=axis`` for sync-BN, as the JAX step requires."""
    body = dp_step_body(model, loss_cfg, optimizer, mesh, axis)

    def step(batch, lr: float, class_weights) -> Dict[str, torch.Tensor]:
        set_lr(optimizer, lr)
        return body(batch, class_weights)

    return step


def make_dp_multi_train_step(model: torch.nn.Module, loss_cfg, optimizer, mesh: DeviceMesh,
                             k: int, axis: str = "data",
                             ema: Optional[Dict[str, torch.Tensor]] = None,
                             ema_decay: float = 0.0) -> MultiTrainStep:
    """K data-parallel optimizer steps a dispatch over a stacked batch
    sharded on its second dim ([K, B/P, ...], ``shard_batch(..., dim=1)``):
    K of exactly :func:`dp_step_body`, each followed by the EMA update when
    ``ema`` is given, with the stacked [K] metrics (train_step.py:96-170).
    On the card a dispatch replays one CUDA graph of the K steps, the NCCL
    all-reduces captured in it (train/loop.py::GraphSteps: a capture that
    fails raises); gloo cannot be captured, so on the CPU the K steps run
    eagerly."""
    body = dp_step_body(model, loss_cfg, optimizer, mesh, axis)
    return MultiTrainStep(model, loss_cfg, optimizer, k, ema, ema_decay, body=body)


def make_dp_eval_step(model: torch.nn.Module, num_classes: int, mesh: DeviceMesh,
                      axis: str = "data") -> Callable:
    """``step(batch, class_weights, params=None) -> (confusion, loss)`` on
    this rank's rows: the confusion matrices summed and the losses averaged
    over the ranks (train_step.py:173-199). A padded tail batch shards
    with its mask, so every rank counts only its real rows."""
    inner = make_eval_step(model, num_classes)
    group = mesh.get_group(axis)

    def step(batch, class_weights, params=None):
        cm, loss = inner(batch, class_weights, params)
        with torch.inference_mode():
            cm, loss = cm.clone(), loss.clone()
            dist.all_reduce(cm, group=group)
            dist.all_reduce(loss, group=group)
            return cm, loss.div_(dist.get_world_size(group))

    return step

