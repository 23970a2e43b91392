"""Expert parallelism over a ("data", "expert") mesh (counterpart of
pointcloud_bridge_tpu/parallel/ep.py), for ``ptv3_moe``.

The batch splits over "data"; every ``experts_*`` parameter of a
MoEFeedForward (models/moe.py) keeps this rank's rows of its leading E axis
over "expert", and so do its Adam moments; everything else is replicated.
The JAX step is the logical single-device program that GSPMD partitions;
this one computes that program by hand, with no all-to-all (gloo has
none): the ranks of a data row hold the same tokens, each routes them all,
runs the experts it holds over the tokens routed to them, and the partial
outputs are summed over "expert" inside autograd. Two quantities are
global in the JAX program and stay global here: the MoE group size and
capacity, taken from the global token count (a rank must hold whole
groups), and the Switch load-balance loss E sum_e f_e p_e, whose f_e and
p_e are averaged over "data" before the product. The BatchNorms sync over
"data" (the model built with ``axis_name="data"``).

The loss is the task loss of the global batch (the logits gathered over
"data" inside autograd) plus ``aux_coef`` times the mean of the MoE
layers' load-balance losses, which this step alone adds (ep.py:92-130).
Every rank computes that loss L; with the collectives' backwards their
exact transposes (utils/collectives.py), the sum of the ranks' gradients
of a leaf's holders is R dL over the R ranks of the mesh: a replicated
leaf's gradient is the sum over the mesh over R, an expert leaf's the sum
over "data" over R.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..models.moe import MoEFeedForward
from ..train.loop import loss_fn_for, set_lr
from ..utils.collectives import all_gather, axis_group
from .mesh import make_named_mesh, rank_rows, shard_batch
from .sharding import gather_plain
from .train_step import all_reduce_bucket_

AXES = ("data", "expert")


def make_ep_mesh(dp: int, ep: int) -> DeviceMesh:
    """Mesh with axes ("data", "expert") of sizes dp and ep over the world."""
    return make_named_mesh((dp, ep), AXES)


def expert_leaves(model: torch.nn.Module) -> list:
    """The names of the ``experts_*`` parameters."""
    return [k for k, _ in model.named_parameters() if k.rsplit(".", 1)[-1].startswith("experts_")]


def ep_state_shardings(model: torch.nn.Module, optimizer=None) -> Dict[str, Optional[str]]:
    """Leaf name -> "expert" for an ``experts_*`` parameter and its Adam
    moments (``<name>.exp_avg``, ``<name>.exp_avg_sq``), None for a
    replicated one."""
    experts = set(expert_leaves(model))
    out = {}
    for name, p in model.named_parameters():
        out[name] = "expert" if name in experts else None
        for key, v in (optimizer.state.get(p, {}) if optimizer is not None else {}).items():
            if torch.is_tensor(v) and v.dim() == p.dim():
                out[f"{name}.{key}"] = out[name]
    return out


def shard_experts(model: torch.nn.Module, optimizer, mesh: DeviceMesh) -> None:
    """Keep this rank's experts of every MoE layer, and their moments, in
    place (the same Parameter objects), and give the layers the mesh's
    axes. A second call changes nothing."""
    ep = mesh.size(mesh.mesh_dim_names.index("expert"))
    with torch.no_grad():
        for m in model.modules():
            if not isinstance(m, MoEFeedForward) or m.ep_axes is not None:
                continue
            if m.num_experts % ep:
                raise ValueError(f"{m.num_experts} experts do not split over {ep} ranks")
            rows = rank_rows(m.num_experts, mesh, "expert")
            for p in (m.experts_proj_kernel, m.experts_proj_bias, m.experts_out_kernel,
                      m.experts_out_bias):
                for key, v in (optimizer.state.get(p, {}) if optimizer is not None else {}).items():
                    if torch.is_tensor(v) and v.shape == p.shape:
                        optimizer.state[p][key] = v[rows].clone()
                p.data = p.data[rows].clone()
                p.grad = None
            m.ep_axes, m.expert_offset = AXES, rows.start


def local_tensors(model: torch.nn.Module, mesh: DeviceMesh,
                  tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Single-device tensors by parameter name (the EMA weights) in this
    rank's layout."""
    experts = set(expert_leaves(model))
    return {k: v[rank_rows(v.shape[0], mesh, "expert")].clone() if k in experts else v
            for k, v in tensors.items()}


def full_tensors(model: torch.nn.Module, mesh: DeviceMesh,
                 tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``tensors`` by parameter name in the single-device layout: the
    expert leaves gathered over "expert". Every rank must call it."""
    experts, group = set(expert_leaves(model)), mesh.get_group("expert")
    return {k: gather_plain(v.detach(), group) if k in experts else v
            for k, v in tensors.items()}


def aux_mean(model: torch.nn.Module) -> torch.Tensor:
    """The mean of the MoE layers' load-balance losses of the last forward
    (ep.py:81-89)."""
    found = [m.aux_loss for m in model.modules()
             if isinstance(m, MoEFeedForward) and m.aux_loss is not None]
    if not found:
        raise ValueError("expert parallelism: the model ran no MoE layer")
    return torch.stack(found).float().mean()


def make_ep_train_step(model: torch.nn.Module, loss_cfg, optimizer, mesh: DeviceMesh,
                       aux_coef: float = 1e-2):
    """Returns ``(step, place)`` as the JAX ``make_ep_train_step`` does.
    ``place(batch=None)`` keeps this rank's experts (the first call) and
    returns this rank's rows of ``batch`` over "data"; ``step(batch, lr,
    class_weights) -> {"loss", "aux_loss", "acc"}`` runs one update of
    task loss + ``aux_coef`` x aux loss. ``model`` is built with
    ``axis_name="data"``."""
    if not expert_leaves(model):
        raise ValueError("parallel.mode=ep requires a mixture-of-experts model (experts_* "
                         "param leaves); use ptv3_moe (model.extra num_experts>0)")
    loss_fn = loss_fn_for(loss_cfg)
    world, data = axis_group(AXES), mesh.get_group("data")
    r = dist.get_world_size(world)
    device = next(model.parameters()).device

    def place(batch=None):
        shard_experts(model, optimizer, mesh)
        return None if batch is None else shard_batch(batch, mesh, "data", device=device)

    def step(batch, lr: float, class_weights) -> Dict[str, torch.Tensor]:
        place()
        set_lr(optimizer, lr)
        model.train()
        optimizer.zero_grad(set_to_none=True)
        logits = all_gather(model(batch["points"], batch["colors"]), "data", dim=0)
        labels, xyz = gather_plain(batch["labels"], data), gather_plain(batch["points"], data)
        task = loss_fn(logits, labels, xyz, class_weights)
        aux = aux_mean(model)
        (task + aux_coef * aux).backward()
        with torch.no_grad():
            for m in model.modules():  # the step keeps no graph
                if isinstance(m, MoEFeedForward) and m.aux_loss is not None:
                    m.aux_loss = m.aux_loss.detach()
            experts = set(expert_leaves(model))
            grads, mine = [], []
            for name, p in model.named_parameters():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                (mine if name in experts else grads).append(p.grad)
            # every rank holds L: a leaf's gradient is its holders' sum over R
            all_reduce_bucket_(grads, world, mean=False)
            all_reduce_bucket_(mine, data, mean=False)
            torch._foreach_div_(grads + mine, float(r))
            acc = (logits.argmax(-1) == labels).float().mean()
        optimizer.step()
        return {"loss": task.detach(), "aux_loss": aux.detach(), "acc": acc}

    return step, place
