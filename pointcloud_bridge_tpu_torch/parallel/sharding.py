"""Tensor parallelism over a ("data", "model") mesh (counterpart of
pointcloud_bridge_tpu/parallel/sharding.py).

The batch splits over "data". The large kernels split their output
channels over "model", the column-parallel rule of the JAX package's
``_kernel_rule`` (sharding.py:36-48): a PointConv or Dense whose kernel,
as [out, in], has at least ``1 << 14`` elements and an output dimension
that "model" divides keeps this rank's rows of it, and so do its Adam
moments; biases, BatchNorms and small kernels stay whole on every rank.
The JAX step is the logical single-device program that GSPMD partitions;
this one computes the same program by hand:

- a column-parallel layer gathers its output columns from the "model"
  ranks before the next layer (models/common.py::linear), and its input's
  gradient is summed over them;
- the BatchNorms take their statistics over the "data" ranks (the model is
  built with ``axis_name="data"``), which is what the JAX program's
  batch-axis mean over the whole batch is;
- the loss is that of the global batch: the logits are gathered over
  "data" inside autograd and every rank takes the loss of all of them;
  each rank's backward reaches its own rows, so the gradients summed over
  "data" are the global loss's.

:func:`global_step_body` and :func:`make_global_eval_step` are shared with
FSDP (fsdp.py), whose program is the same.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from .. import losses as L
from ..models.common import Dense, PointConv
from ..train.loop import loss_fn_for, set_lr
from ..utils import metrics as M
from ..utils.collectives import gather_list, gather_rows
from .mesh import make_named_mesh, rank_rows, shard_batch
from .train_step import all_reduce_bucket_, gradients

MIN_ELEMS = 1 << 14


def make_2d_mesh(dp: int, tp: int) -> DeviceMesh:
    """Mesh with axes ("data", "model") of sizes dp and tp over the world."""
    return make_named_mesh((dp, tp), ("data", "model"))


def gather_plain(t: torch.Tensor, group: Any, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along ``dim``, outside autograd."""
    return torch.cat(gather_list(t, group), dim)


def _column_parallel(module: torch.nn.Module, tp: int, min_elems: int) -> bool:
    if not isinstance(module, (PointConv, Dense)):
        return False
    if module.column_group is not None:
        return True
    w = module.weight
    return w.numel() >= min_elems and w.shape[0] % tp == 0


def param_shardings(model: torch.nn.Module, mesh: DeviceMesh,
                    min_elems: int = MIN_ELEMS) -> Dict[str, Optional[str]]:
    """Parameter name -> "model" for a kernel that splits its output
    channels over the "model" axis, None for one every rank holds whole."""
    tp = mesh.size(mesh.mesh_dim_names.index("model"))
    out = {}
    for mname, m in model.named_modules():
        for pname, _ in m.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            out[name] = "model" if pname == "weight" and _column_parallel(m, tp, min_elems) else None
    return out


def state_shardings(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    mesh: DeviceMesh, min_elems: int = MIN_ELEMS) -> Dict[str, Optional[str]]:
    """:func:`param_shardings` with each parameter's optimizer moments
    beside it (``<name>.exp_avg``, ``<name>.exp_avg_sq``), which follow it."""
    shard = param_shardings(model, mesh, min_elems)
    out = dict(shard)
    for name, p in model.named_parameters():
        for key, v in optimizer.state.get(p, {}).items():
            if torch.is_tensor(v) and v.dim() == p.dim():
                out[f"{name}.{key}"] = shard[name]
    return out


def shard_columns(model: torch.nn.Module, optimizer: torch.optim.Optimizer, mesh: DeviceMesh,
                  min_elems: int = MIN_ELEMS) -> None:
    """Keep this rank's rows of every column-parallel kernel, and of its
    optimizer moments, in place (the same Parameter objects, so the
    optimizer goes on holding them)."""
    group, tp = mesh.get_group("model"), mesh.size(mesh.mesh_dim_names.index("model"))
    with torch.no_grad():
        for m in model.modules():
            if not _column_parallel(m, tp, min_elems) or m.column_group is not None:
                continue
            p = m.weight
            rows = rank_rows(p.shape[0], mesh, "model")
            for key, v in optimizer.state.get(p, {}).items():
                if torch.is_tensor(v) and v.shape == p.shape:
                    optimizer.state[p][key] = v[rows].clone()
            p.data = p.data[rows].clone()
            p.grad = None
            m.column_group = group


def full_tensors(model: torch.nn.Module, tensors: Dict[str, torch.Tensor],
                 mesh: DeviceMesh) -> Dict[str, torch.Tensor]:
    """``tensors`` (parameter name -> this rank's tensor: the parameters,
    the EMA weights) in the single-device layout: a column-parallel kernel
    gathered over "model". Every rank must call it."""
    shard = param_shardings(model, mesh)
    group = mesh.get_group("model")
    return {k: gather_plain(v.detach(), group) if shard.get(k) else v
            for k, v in tensors.items()}


def full_optimizer_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                         gather: Callable) -> dict:
    """The optimizer's state_dict in the single-device layout: each moment
    of a sharded parameter passed through ``gather(param, moment)``."""
    sd = optimizer.state_dict()
    params = [p for g in optimizer.param_groups for p in g["params"]]
    for index, st in sd["state"].items():
        p = params[index]
        sd["state"][index] = {k: gather(p, v) if torch.is_tensor(v) and v.dim() == p.dim()
                              and v.dim() > 0 else v for k, v in st.items()}
    return sd


def global_step_body(model: torch.nn.Module, loss_cfg, optimizer, mesh: DeviceMesh,
                     reduce_gradients: Callable, loss_scale: float = 1.0,
                     axis: str = "data") -> Callable:
    """``body(batch, class_weights) -> {"loss", "acc"}``: one optimizer step
    of the global batch's loss from this rank's rows. The logits are
    gathered over ``axis`` inside autograd, the labels and points outside
    it; every rank computes the same loss and its backward (the loss times
    ``loss_scale``) reaches its own rows; ``reduce_gradients()`` then makes
    every rank's gradients those of the global loss."""
    loss_fn = loss_fn_for(loss_cfg)
    group = mesh.get_group(axis)

    def body(batch, class_weights) -> Dict[str, torch.Tensor]:
        model.train()
        xyz, colors, labels = batch["points"], batch["colors"], batch["labels"]
        optimizer.zero_grad(set_to_none=True)
        logits = gather_rows(model(xyz, colors), group)
        labels, xyz = gather_plain(labels, group), gather_plain(xyz, group)
        loss = loss_fn(logits, labels, xyz, class_weights)
        (loss * loss_scale if loss_scale != 1.0 else loss).backward()
        reduce_gradients()
        optimizer.step()
        with torch.no_grad():
            acc = (logits.argmax(-1) == labels).float().mean()
        return {"loss": loss.detach(), "acc": acc}

    return body


class _Swapped:
    """The parameters' values replaced by ``params`` (name -> tensor of the
    same layout) for a block, then restored: the EMA weights in
    validation. An FSDP2 model keeps its root's parameters gathered after a
    forward; it is resharded first, so that the swap writes the shards the
    next forward gathers."""

    def __init__(self, model: torch.nn.Module, params: Optional[Dict[str, torch.Tensor]]):
        self.model, self.params = model, params

    def _pairs(self):
        if hasattr(self.model, "reshard"):
            self.model.reshard()
        return [(p, self.params[k]) for k, p in self.model.named_parameters()]

    def __enter__(self):
        if self.params is None:
            return
        with torch.no_grad():
            pairs = self._pairs()
            self.saved = [p.detach().clone() for p, _ in pairs]
            for p, v in pairs:
                p.copy_(v)

    def __exit__(self, *exc):
        if self.params is None:
            return
        with torch.no_grad():
            for (p, _), v in zip(self._pairs(), self.saved):
                p.copy_(v)


def make_global_eval_step(model: torch.nn.Module, num_classes: int, mesh: DeviceMesh,
                          axis: str = "data") -> Callable:
    """``step(batch, class_weights, params=None) -> (confusion, loss)`` of
    the global batch from this rank's rows: the logits, labels and mask
    gathered over ``axis``, then the single-device eval's loss and masked
    confusion matrix (the JAX engine evaluates tp and fsdp with the plain
    step on the global batch, loop.py:720, 826). ``params`` (the EMA
    weights, in this rank's layout) stand in for the parameters."""
    group = mesh.get_group(axis)

    def step(batch, class_weights, params=None):
        model.eval()
        with _Swapped(model, params), torch.inference_mode():
            logits = gather_plain(model(batch["points"], batch["colors"]), group)
            labels = gather_plain(batch["labels"], group)
            mask = gather_plain(batch["mask"], group)
            loss = L.weighted_cross_entropy(logits, labels, class_weights)
            cm = M.masked_confusion_matrix(logits.argmax(-1), labels,
                                           mask[:, None].expand(labels.shape), num_classes)
        return cm, loss

    return step


def make_tp_train_step(model: torch.nn.Module, loss_cfg, optimizer, mesh: DeviceMesh,
                       min_elems: int = MIN_ELEMS):
    """Returns ``(step, place)`` as the JAX ``make_tp_train_step`` does.
    ``place(batch=None)`` splits the column-parallel kernels and their
    moments over "model" (the first call) and returns this rank's rows of
    ``batch`` on its device; ``step(batch, lr, class_weights)`` runs one
    update of the global loss and returns its loss and accuracy. ``model``
    must be built with ``axis_name="data"``."""
    data = mesh.get_group("data")
    body = global_step_body(
        model, loss_cfg, optimizer, mesh,
        lambda: all_reduce_bucket_(gradients(model), data, mean=False))
    device = next(model.parameters()).device

    def place(batch=None):
        shard_columns(model, optimizer, mesh, min_elems)
        return None if batch is None else shard_batch(batch, mesh, "data", device=device)

    def step(batch, lr: float, class_weights) -> Dict[str, torch.Tensor]:
        set_lr(optimizer, lr)
        return body(batch, class_weights)

    return step, place
