"""Sequence parallelism over the point axis (counterpart of
pointcloud_bridge_tpu/parallel/sp.py).

Two contracts, as in the JAX package:

- ``shard_inputs=True`` (global PTv3): each rank holds its contiguous slice
  of the N axis of every cloud, global attention is ring attention
  (parallel/ring.py) and the rest of the model is pointwise; the model is
  built with ``sp_axis=axis``;
- ``shard_inputs=False`` (the neighbourhood models, windowed PTv3,
  ``ptv3_pooled``): the inputs are whole on every rank and the model
  slices its queries itself and gathers its logits (models/common.py).

For training the model also takes ``axis_name=axis`` (or
``(dp_axis, axis)`` on a dp x sp mesh), so its BatchNorms take the
statistics of every point. The parameters are the single-device model's,
replicated, so checkpoints move freely between modes.

The loss is decomposed (sp.py:200-210): each rank's (weighted NLL sum,
weight sum), summed over the axes by :func:`~..utils.collectives.psum`
before the division, so a skewed class mix across shards does not bias the
weighted mean. Every rank then holds the global loss L. The collectives'
backwards are their exact transposes (utils/collectives.py), so autograd on
each rank gives that rank's share of the gradient of the sum of the ranks'
objectives, R L over the R ranks of the mesh; the ranks' gradients summed
and divided by R are the gradient of L. That is the mean over the mesh,
one all-reduce of a flat bucket, the JAX step's ``pmean`` reached from the
port's own collectives. Losses that read whole-cloud statistics
(``bridge_structure``, ``sol``) are refused, as the JAX step refuses them.
A rank's Dropouts draw their own stream (``rank_seed`` in the trainer), as
the JAX step folds the shard's index into its key.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .. import losses as L
from ..train.loop import MultiTrainStep, batch_to_device, set_lr
from ..utils import metrics as M
from ..utils.collectives import axis_group, psum
from .mesh import rank_rows
from .sharding import _Swapped
from .train_step import all_reduce_bucket_, gradients

DECOMPOSABLE = ("ce", "weighted_ce")


def _axes(axis: str, dp_axis: Optional[str]):
    return (dp_axis, axis) if dp_axis else axis


def check_decomposable(loss_cfg) -> None:
    if loss_cfg.name not in DECOMPOSABLE:
        raise ValueError(
            f"loss '{loss_cfg.name}' is not decomposable over N-axis shards (it reads "
            "whole-cloud xyz statistics); SP training supports ce/weighted_ce only")


def shard_sp_batch(batch: Dict[str, Any], mesh: DeviceMesh, axis: str = "sp",
                   dp_axis: Optional[str] = None, shard_inputs: bool = True,
                   dim: int = 0, device=None) -> Dict[str, torch.Tensor]:
    """This rank's part of a host batch: its rows over ``dp_axis`` and, with
    ``shard_inputs``, its slice of the points (the dim after the rows) over
    ``axis``; the block mask follows the rows. ``dim=1`` is the stacked
    [K, B, ...] layout of multi-step dispatch."""
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if mesh.device_type == "cuda" else torch.device("cpu"))
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        index = [slice(None)] * v.ndim
        if dp_axis:
            index[dim] = rank_rows(v.shape[dim], mesh, dp_axis)
        if shard_inputs and v.ndim > dim + 1 and k in ("points", "colors", "labels"):
            index[dim + 1] = rank_rows(v.shape[dim + 1], mesh, axis)
        out[k] = np.ascontiguousarray(v[tuple(index)])
    return batch_to_device(out, device)


def make_sp_forward(model: torch.nn.Module) -> Callable:
    """``forward(xyz, feats) -> logits`` in eval mode on this rank's part of
    the batch (:func:`shard_sp_batch`). ``model`` is built with
    ``sp_axis``; its contract says what a rank holds: under the sharded
    one (global PTv3) this rank's slice of the logits, else the whole N."""

    def forward(xyz, feats):
        model.eval()
        with torch.inference_mode():
            return model(xyz, feats)

    return forward


def make_sp_eval_step(model: torch.nn.Module, num_classes: int, axis: str = "sp",
                      shard_inputs: bool = True) -> Callable:
    """``step(batch, class_weights, params=None) -> (confusion, loss)`` with
    the single-device eval's values. With ``shard_inputs`` the points,
    colours and labels are this rank's slices of N, and the confusion
    matrix and the weighted CE's sums are summed over the axis; without,
    every rank holds the whole logits and computes them whole
    (sp.py:62-118)."""
    group = axis_group(axis)

    def step(batch, class_weights, params=None):
        model.eval()
        labels = batch["labels"]
        with _Swapped(model, params), torch.inference_mode():
            logits = model(batch["points"], batch["colors"])
            mask = batch["mask"][:, None].expand(labels.shape)
            cm = M.masked_confusion_matrix(logits.argmax(-1), labels, mask, num_classes)
            if not shard_inputs:
                return cm, L.weighted_cross_entropy(logits, labels, class_weights)
            numer, denom = L.weighted_cross_entropy_sums(logits, labels, class_weights, 0.0)
            sums = torch.stack([numer, denom.to(numer.dtype)])
            cm = cm.clone()
            dist.all_reduce(sums, group=group)
            dist.all_reduce(cm, group=group)
            return cm, sums[0] / torch.clamp(sums[1], min=1e-8)

    return step


def sp_step_body(model: torch.nn.Module, loss_cfg, optimizer, axis: str = "sp",
                 dp_axis: Optional[str] = None) -> Callable:
    """``body(batch, class_weights) -> {"loss", "acc"}``: one sp optimizer
    step, the lr already set (shared by the single and multi-step)."""
    check_decomposable(loss_cfg)
    axes = _axes(axis, dp_axis)
    group = axis_group(axes)

    def body(batch, class_weights) -> Dict[str, torch.Tensor]:
        model.train()
        xyz, colors, labels = batch["points"], batch["colors"], batch["labels"]
        optimizer.zero_grad(set_to_none=True)
        logits = model(xyz, colors)
        cw = class_weights if loss_cfg.use_class_weights else None
        numer, denom = L.weighted_cross_entropy_sums(logits, labels, cw,
                                                     loss_cfg.label_smoothing)
        numer, denom = psum(numer, axes), psum(denom.to(numer.dtype), axes)
        loss = numer / torch.clamp(denom, min=1e-8)
        loss.backward()
        with torch.no_grad():
            # R ranks each hold L: the sum of their gradients is R dL
            all_reduce_bucket_(gradients(model), group)
            acc = (logits.argmax(-1) == labels).float().mean().reshape(1)
            all_reduce_bucket_([acc], group)
        optimizer.step()
        return {"loss": loss.detach(), "acc": acc[0]}

    return body


def make_sp_train_step(model: torch.nn.Module, loss_cfg, optimizer, axis: str = "sp",
                       dp_axis: Optional[str] = None) -> Callable:
    """``step(batch, lr, class_weights) -> {"loss", "acc"}`` on this rank's
    part of the batch (:func:`shard_sp_batch`, with the ``shard_inputs`` of
    the model's contract). ``model`` is built with ``sp_axis=axis`` and
    ``axis_name=axis`` (``(dp_axis, axis)`` with ``dp_axis``); the loss is
    the global weighted mean (ce/weighted_ce only)."""
    body = sp_step_body(model, loss_cfg, optimizer, axis, dp_axis)

    def step(batch, lr: float, class_weights) -> Dict[str, torch.Tensor]:
        set_lr(optimizer, lr)
        return body(batch, class_weights)

    return step


def make_sp_multi_train_step(model: torch.nn.Module, loss_cfg, optimizer, k: int,
                             axis: str = "sp", dp_axis: Optional[str] = None,
                             ema: Optional[Dict[str, torch.Tensor]] = None,
                             ema_decay: float = 0.0) -> MultiTrainStep:
    """K sp optimizer steps a dispatch over a stacked batch ([K, B, ...],
    :func:`shard_sp_batch` with ``dim=1``): K of exactly the single step's
    body, each followed by the EMA update when ``ema`` is given
    (sp.py:231-307). On the card a dispatch is one CUDA graph when the
    collectives are NCCL's; gloo cannot be captured, so under gloo the K
    steps run eagerly."""
    body = sp_step_body(model, loss_cfg, optimizer, axis, dp_axis)
    return MultiTrainStep(model, loss_cfg, optimizer, k, ema, ema_decay, body=body)
