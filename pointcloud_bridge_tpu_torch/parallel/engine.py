"""The trainer's parallel modes (counterpart of the mesh branches of
pointcloud_bridge_tpu/train/loop.py:396-446, 690-880).

``train/loop.py::mesh_request`` reads ``config.parallel`` as the JAX
trainer does: a mesh when ``num_devices`` > 1, or -1 with a world above
one. Modes dp, tp
and fsdp run inside the initialised default process group (``torchrun``
starts it on the card); sp, pp and ep are "Parallel layer, part 2". A
:class:`MeshEngine` builds the mesh, keeps the JAX trainer's refusals,
places the model and the optimizer, gives the steps of its mode and puts
the state back in the single-device layout for the checkpoints, which
rank 0 alone writes, so ``infer_cli`` serves them unchanged.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Shard, distribute_tensor

from ..train.loop import MultiEvalStep
from . import fsdp as F
from . import sharding as S
from .mesh import make_mesh, rank_rows, replicate, shard_batch, world_size
from .train_step import (
    make_dp_eval_step,
    make_dp_multi_train_step,
    make_dp_train_step,
)

PART_2 = "ROADMAP.md Queue 1, \"Parallel layer, part 2\""


class MeshEngine:
    """One rank's part of a mesh run of mode dp, tp or fsdp."""

    def __init__(self, config, ndev: int):
        tcfg, par = config.train, config.parallel
        self.mode, self.axis = par.mode, par.data_axis
        if self.mode not in ("dp", "sp", "fsdp", "pp", "tp", "ep"):
            raise ValueError(f"unknown parallel.mode '{self.mode}'")
        if self.mode in ("sp", "pp", "ep"):
            raise NotImplementedError(
                f"parallel.mode '{self.mode}' is not ported to PyTorch yet; {PART_2}")
        world = world_size()
        if ndev != world:
            raise ValueError(f"parallel.num_devices {ndev} over a world of {world} ranks")
        accum = int(getattr(tcfg, "accum_steps", 1))
        spd = int(getattr(tcfg, "steps_per_dispatch", 1))
        if self.mode in ("fsdp", "tp"):
            if accum > 1:  # as the JAX trainer (loop.py:702-712)
                raise ValueError(f"accum_steps is not supported with parallel.mode={self.mode}")
            if spd > 1:
                raise ValueError(
                    f"steps_per_dispatch is not supported with parallel.mode={self.mode}")
        elif accum > 1:
            # the JAX dp step has no accumulation and leaves accum_steps unread
            raise ValueError("accum_steps is not supported with parallel.mode=dp")
        self.dp_size = ndev
        if self.mode == "tp":
            tp = max(1, int(par.tp_axis_size))
            if ndev % tp:
                raise ValueError(f"tp_axis_size {tp} must divide {ndev} devices")
            self.dp_size = ndev // tp
            if tcfg.batch_size % self.dp_size:
                raise ValueError(
                    f"batch_size {tcfg.batch_size} must divide the data axis "
                    f"({self.dp_size} of the {self.dp_size}x{tp} mesh)")
        elif tcfg.batch_size % ndev:
            raise ValueError(f"batch_size {tcfg.batch_size} must divide the mesh size {ndev}")
        self.rank = dist.get_rank()
        self.device = self._rank_device(config.device)
        if self.mode == "tp":
            self.mesh = S.make_2d_mesh(self.dp_size, ndev // self.dp_size)
            # the "model" ranks of a data row compute the same activations:
            # their Dropouts must draw the same masks
            self.data_rank = self.mesh.get_local_rank("data")
        else:
            self.mesh = make_mesh(ndev, self.axis)
            self.data_rank = self.rank

    def _rank_device(self, name: str) -> torch.device:
        """``cuda:<LOCAL_RANK>`` under NCCL; the CPU when the caller asked
        for it (gloo). Anything else is refused, never run elsewhere."""
        backend = dist.get_backend()
        if name == "cpu":
            if backend != "gloo":
                raise ValueError(f"device 'cpu' needs the gloo backend, not {backend}")
            return torch.device("cpu")
        if backend != "nccl" or not torch.cuda.is_available():
            raise RuntimeError(
                f"device '{name}': a mesh on the card needs CUDA and the NCCL backend "
                f"(backend {backend}, CUDA available {torch.cuda.is_available()})")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
        return dev

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def describe(self) -> str:
        if self.mode == "tp":
            return (f"tensor-parallel over a {self.dp_size}x{self.mesh.size(1)} "
                    "(data, model) mesh")
        if self.mode == "fsdp":
            return (f"fsdp/ZeRO-3 over {self.mesh.size()} ranks "
                    f"(params + optimizer moments sharded over '{self.axis}')")
        return f"data-parallel over {self.mesh.size()} ranks"

    def build(self, model, loss_cfg, optimizer, num_classes: int, spd: int,
              ema: Optional[Dict[str, torch.Tensor]], ema_decay: float) -> Dict[str, Any]:
        """Place the model, the optimizer (its state, a resumed run's, in
        the single-device layout) and the EMA weights, and return the steps
        {train_step, multi_step, eval_step, multi_eval, ema}."""
        self._model = model
        out = {"multi_step": None, "multi_eval": None}
        if self.mode == "dp":
            replicate(model, optimizer, list((ema or {}).values()))
            out["train_step"] = make_dp_train_step(model, loss_cfg, optimizer, self.mesh,
                                                   self.axis)
            out["eval_step"] = make_dp_eval_step(model, num_classes, self.mesh, self.axis)
            if spd > 1:
                out["multi_step"] = make_dp_multi_train_step(
                    model, loss_cfg, optimizer, self.mesh, spd, self.axis, ema, ema_decay)
                out["multi_eval"] = MultiEvalStep(out["eval_step"], spd)
            out["ema"] = ema
            return out
        if self.mode == "tp":
            out["train_step"], place = S.make_tp_train_step(model, loss_cfg, optimizer,
                                                            self.mesh)
        else:
            out["train_step"], place = F.make_fsdp_train_step(model, loss_cfg, optimizer,
                                                              self.mesh, self.axis)
        place()
        out["eval_step"] = S.make_global_eval_step(model, num_classes, self.mesh, self.axis)
        if ema is not None:
            ema = {k: self._local(k, v) for k, v in ema.items()}
        out["ema"] = ema
        return out

    def _local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """A single-device tensor of parameter ``name`` in this rank's
        layout."""
        if self.mode == "fsdp":
            return distribute_tensor(full, self.mesh, [Shard(0)])
        if S.param_shardings(self._model, self.mesh).get(name):
            return full[rank_rows(full.shape[0], self.mesh, "model")].clone()
        return full

    def put_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """This rank's rows of a host batch; the stacked [K, B, ...] layout
        splits its second dim."""
        dim = 1 if np.ndim(batch["points"]) == 4 else 0
        return shard_batch(batch, self.mesh, self.axis, dim, self.device)

    def full_model_state(self, model) -> Dict[str, torch.Tensor]:
        """The model's state_dict in the single-device layout (a collective:
        every rank calls it)."""
        if self.mode == "fsdp":
            return F.full_state_dict(model)
        sd = model.state_dict()
        return S.full_tensors(model, sd, self.mesh) if self.mode == "tp" else sd

    def full_tensors(self, model, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if self.mode == "fsdp":
            return F.full_tensors(tensors)
        return S.full_tensors(model, tensors, self.mesh) if self.mode == "tp" else tensors

    def full_optimizer_state(self, model, optimizer) -> dict:
        if self.mode == "fsdp":
            return F.full_fsdp_optimizer_state(model, optimizer)
        if self.mode == "tp":
            shard = S.param_shardings(model, self.mesh)
            names = {id(p): k for k, p in model.named_parameters()}
            group = self.mesh.get_group("model")
            return S.full_optimizer_state(
                model, optimizer,
                lambda p, v: S.gather_plain(v, group) if shard.get(names[id(p)]) else v)
        return optimizer.state_dict()
