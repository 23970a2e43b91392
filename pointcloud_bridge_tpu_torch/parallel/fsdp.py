"""FSDP / ZeRO-3 over the 1-D "data" mesh (counterpart of
pointcloud_bridge_tpu/parallel/fsdp.py).

The JAX package annotates every leaf of at least ``1 << 12`` elements to
split its largest divisible axis over the mesh and lets GSPMD place the
all-gathers and reduce-scatters around the logical single-device program.
Here PyTorch's FSDP2 (``fully_shard``) does that placement: every
parameter becomes a DTensor split along dim 0 over the mesh (padded where
the mesh does not divide it), gathered for the forward and the backward,
its gradient reduce-scattered; Adam keeps its moments in the same layout,
so each rank holds about 1/P of every leaf and its moments. The layout is
not JAX's (dim 0, and small leaves split too), the share a rank holds is.

The step is the logical single-device program, as the JAX one is: the
loss is that of the global batch (parallel/sharding.py::global_step_body)
and the BatchNorms take their statistics over the "data" ranks (the model
built with ``axis_name="data"``, which the JAX engine does not need under
GSPMD and this one does, each rank seeing only its rows). FSDP2 averages
the gradients over the mesh, so each rank's backward starts from the loss
times P, which makes that average the global loss's gradient.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.fsdp import fully_shard
from torch.distributed.tensor import DTensor, Shard, distribute_tensor

from ..train.loop import set_lr
from .mesh import make_mesh, shard_batch
from .sharding import full_optimizer_state, global_step_body

MIN_ELEMS = 1 << 12


def make_fsdp_mesh(n: int, axis: str = "data") -> DeviceMesh:
    """1-D (axis,) mesh over the world of ``n`` ranks."""
    return make_mesh(n, axis)


def fsdp_state_shardings(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                         min_elems: int = MIN_ELEMS) -> Dict[str, float]:
    """Leaf name -> the share of it this rank holds, for every parameter of
    at least ``min_elems`` elements and its optimizer moments
    (``<name>.exp_avg``, ``<name>.exp_avg_sq``): about 1/P once placed."""
    out = {}
    for name, p in model.named_parameters():
        if p.numel() < min_elems:
            continue
        leaves = {name: p, **{f"{name}.{k}": v for k, v in optimizer.state.get(p, {}).items()
                              if torch.is_tensor(v) and v.dim() == p.dim()}}
        for key, v in leaves.items():
            local = v.to_local() if isinstance(v, DTensor) else v
            out[key] = local.numel() / v.numel()
    return out


def shard_model(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                mesh: DeviceMesh) -> None:
    """``fully_shard`` the model over the mesh and move the optimizer onto
    its new (DTensor) parameters, any state it holds (a resumed run's
    moments, in the single-device layout) split the same way."""
    if any(isinstance(p, DTensor) for p in model.parameters()):
        return
    old = list(model.parameters())
    fully_shard(model, mesh=mesh)
    new = dict(zip(map(id, old), model.parameters()))
    for group in optimizer.param_groups:
        group["params"] = [new[id(p)] for p in group["params"]]
    for p in old:
        st = optimizer.state.pop(p, None)
        if st is not None:
            optimizer.state[new[id(p)]] = {
                k: distribute_tensor(v, mesh, [Shard(0)])
                if torch.is_tensor(v) and v.shape == p.shape and v.dim() > 0 else v
                for k, v in st.items()}


def full_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The model's state_dict in the single-device layout (every rank must
    call it: each DTensor is gathered)."""
    return {k: v.full_tensor() if isinstance(v, DTensor) else v
            for k, v in model.state_dict().items()}


def full_tensors(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.full_tensor() if isinstance(v, DTensor) else v for k, v in tensors.items()}


def full_fsdp_optimizer_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> dict:
    return full_optimizer_state(
        model, optimizer, lambda p, v: v.full_tensor() if isinstance(v, DTensor) else v)


def make_fsdp_train_step(model: torch.nn.Module, loss_cfg, optimizer, mesh: DeviceMesh,
                         axis: str = "data"):
    """Returns ``(step, place)`` as the JAX ``make_fsdp_train_step`` does.
    ``place(batch=None)`` shards the model and the optimizer (the first
    call) and returns this rank's rows of ``batch`` on its device;
    ``step(batch, lr, class_weights)`` runs one update of the global loss.
    FSDP2 splits every leaf, so the JAX step's ``min_elems`` has no
    counterpart here (:func:`fsdp_state_shardings` reports at it)."""
    world = mesh.size()
    body = global_step_body(model, loss_cfg, optimizer, mesh, lambda: None,
                            loss_scale=float(world), axis=axis)
    device = next(model.parameters()).device

    def place(batch=None):
        shard_model(model, optimizer, mesh)
        return None if batch is None else shard_batch(batch, mesh, axis, device=device)

    def step(batch, lr: float, class_weights) -> Dict[str, torch.Tensor]:
        set_lr(optimizer, lr)
        return body(batch, class_weights)

    return step, place
