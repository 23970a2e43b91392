"""The trainer's parallel modes (counterpart of the mesh branches of
pointcloud_bridge_tpu/train/loop.py:396-446, 690-880).

``train/loop.py::mesh_request`` reads ``config.parallel`` as the JAX
trainer does: a mesh when ``num_devices`` > 1, or -1 with a world above
one. Every mode (dp, tp, fsdp, sp, pp, ep) runs inside the initialised
default process group (``torchrun`` starts it on the card). A
:class:`MeshEngine` builds the mesh, keeps the JAX trainer's refusals,
names the model's mesh axes (:meth:`MeshEngine.model_axes`), places the
model and the optimizer, gives the steps of its mode and puts the state
back in the single-device layout for the checkpoints, which rank 0 alone
writes, so ``infer_cli`` serves them unchanged.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Shard, distribute_tensor

from ..train.loop import MultiEvalStep, batch_to_device
from . import ep as E
from . import fsdp as F
from . import pp as PP
from . import sharding as S
from . import sp as SP
from .mesh import make_mesh, make_named_mesh, rank_rows, replicate, shard_batch, world_size
from .train_step import (
    make_dp_eval_step,
    make_dp_multi_train_step,
    make_dp_train_step,
)


class MeshEngine:
    """One rank's part of a mesh run of mode dp, tp, fsdp, sp, pp or ep."""

    def __init__(self, config, ndev: int):
        tcfg, par = config.train, config.parallel
        self.mode, self.axis = par.mode, par.data_axis
        if self.mode not in ("dp", "sp", "fsdp", "pp", "tp", "ep"):
            raise ValueError(f"unknown parallel.mode '{self.mode}'")
        world = world_size()
        if ndev != world:
            raise ValueError(f"parallel.num_devices {ndev} over a world of {world} ranks")
        accum = int(getattr(tcfg, "accum_steps", 1))
        spd = int(getattr(tcfg, "steps_per_dispatch", 1))
        # as the JAX trainer (loop.py:450-452, 600-612, 702-712, 744-756)
        if accum > 1:
            # the JAX dp step has no accumulation and leaves accum_steps unread
            raise ValueError(f"accum_steps is not supported with parallel.mode={self.mode}")
        if self.mode in ("fsdp", "tp", "pp", "ep") and spd > 1:
            raise ValueError(
                f"steps_per_dispatch is not supported with parallel.mode={self.mode}")
        self.dp_size = ndev
        if self.mode in ("tp", "ep"):
            knob = "tp_axis_size" if self.mode == "tp" else "ep_axis_size"
            ax2 = max(1, int(getattr(par, knob)))
            if ndev % ax2:
                raise ValueError(f"{knob} {ax2} must divide {ndev} devices")
            self.dp_size = ndev // ax2
            if tcfg.batch_size % self.dp_size:
                raise ValueError(
                    f"batch_size {tcfg.batch_size} must divide the data axis "
                    f"({self.dp_size} of the {self.dp_size}x{ax2} mesh)")
        elif self.mode == "pp":
            self.microbatches = int(par.pp_microbatches) or ndev
            if tcfg.batch_size % self.microbatches:
                raise ValueError(f"batch_size {tcfg.batch_size} must divide "
                                 f"pp microbatch count {self.microbatches}")
        elif self.mode != "sp" and tcfg.batch_size % ndev:
            raise ValueError(f"batch_size {tcfg.batch_size} must divide the mesh size {ndev}")
        if self.mode == "sp":
            forced = int(par.sp_shard_inputs)
            # ptv3-family global attention shards the points (ring
            # attention); the neighbourhood models and windowed PTv3 take
            # the whole inputs and slice their queries (loop.py:453-466)
            self.shard_inputs = bool(forced) if forced in (0, 1) else (
                config.model.name in ("ptv3", "ptv3_moe")
                and not config.model.extra.get("window_size"))
        self._aux_coef = float(getattr(par, "ep_aux_coef", 1e-2))
        self.rank = dist.get_rank()
        self.device = self._rank_device(config.device)
        if self.mode in ("tp", "ep"):
            self.mesh = make_named_mesh((self.dp_size, ndev // self.dp_size),
                                        ("data", "model" if self.mode == "tp" else "expert"))
            # the "model"/"expert" ranks of a data row compute the same
            # activations: their Dropouts must draw the same masks
            self.data_rank = self.mesh.get_local_rank("data")
        else:
            self.mesh = make_mesh(ndev, self.axis)
            # the stages of a pipeline compute the same embedding and head
            self.data_rank = 0 if self.mode == "pp" else self.rank

    def model_axes(self) -> Dict[str, Any]:
        """The mesh axes the model is built with: ``axis_name`` for its
        BatchNorms (none under pp, whose stages each see the whole batch;
        "data" under tp and ep) and ``sp_axis`` under sp."""
        if self.mode == "pp":
            return {}
        if self.mode in ("tp", "ep"):
            return {"axis_name": "data"}
        if self.mode == "sp":
            return {"axis_name": self.axis, "sp_axis": self.axis}
        return {"axis_name": self.axis}

    def check_model(self, model) -> None:
        """The JAX trainer's refusals of the model (loop.py:620-630,
        758-764), before any data is read: ep needs experts, pp a block
        stack its stages divide."""
        if self.mode == "ep" and not E.expert_leaves(model):
            raise ValueError(
                "parallel.mode=ep requires a mixture-of-experts model (experts_* param "
                "leaves); use ptv3_moe (model.extra num_experts>0)")
        if self.mode == "pp":
            PP.Stages.of(model, self.mesh, self.axis)

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
        if self.mode == "ep":
            return (f"expert-parallel over a {self.dp_size}x{self.mesh.size(1)} "
                    "(data, expert) mesh")
        if self.mode == "sp":
            return (f"sequence-parallel over {self.mesh.size()} ranks "
                    f"(shard_inputs={self.shard_inputs})")
        if self.mode == "pp":
            return (f"pipeline-parallel over {self.mesh.size()} stages "
                    f"({self._model.depth} blocks, {self.microbatches} microbatches/step)")
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
        if self.mode in ("dp", "sp"):
            replicate(model, optimizer, list((ema or {}).values()))
            if self.mode == "dp":
                out["train_step"] = make_dp_train_step(model, loss_cfg, optimizer, self.mesh,
                                                       self.axis)
                out["eval_step"] = make_dp_eval_step(model, num_classes, self.mesh, self.axis)
            else:
                out["train_step"] = SP.make_sp_train_step(model, loss_cfg, optimizer, self.axis)
                out["eval_step"] = SP.make_sp_eval_step(model, num_classes, self.axis,
                                                        self.shard_inputs)
            if spd > 1:
                if self.mode == "dp":
                    out["multi_step"] = make_dp_multi_train_step(
                        model, loss_cfg, optimizer, self.mesh, spd, self.axis, ema=ema,
                        ema_decay=ema_decay)
                else:
                    out["multi_step"] = SP.make_sp_multi_train_step(
                        model, loss_cfg, optimizer, spd, self.axis, ema=ema, ema_decay=ema_decay)
                out["multi_eval"] = MultiEvalStep(out["eval_step"], spd)
            out["ema"] = ema
            return out
        if self.mode == "pp":
            replicate(model, optimizer, list((ema or {}).values()))
            out["train_step"], self._stages = PP.make_pp_train_step(
                model, loss_cfg, optimizer, self.mesh, self.axis, self.microbatches)
            out["eval_step"] = PP.make_pp_eval_step(model, num_classes, self.mesh, self.axis,
                                                    self.microbatches)
            out["ema"] = self._stages.place(optimizer, ema)
            return out
        if self.mode == "tp":
            out["train_step"], place = S.make_tp_train_step(model, loss_cfg, optimizer,
                                                            self.mesh)
        elif self.mode == "ep":
            out["train_step"], place = E.make_ep_train_step(model, loss_cfg, optimizer,
                                                            self.mesh, self._aux_coef)
            replicate(model, optimizer, list((ema or {}).values()))
        else:
            out["train_step"], place = F.make_fsdp_train_step(model, loss_cfg, optimizer,
                                                              self.mesh, self.axis)
        place()
        out["eval_step"] = S.make_global_eval_step(
            model, num_classes, self.mesh, "data" if self.mode == "ep" else self.axis)
        if ema is not None:
            ema = {k: self._local(k, v) for k, v in ema.items()}
        out["ema"] = ema
        return out

    def _local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """A single-device tensor of parameter ``name`` in this rank's
        layout."""
        if self.mode == "fsdp":
            return distribute_tensor(full, self.mesh, [Shard(0)])
        if self.mode == "ep":
            return E.local_tensors(self._model, self.mesh, {name: full})[name]
        if S.param_shardings(self._model, self.mesh).get(name):
            return full[rank_rows(full.shape[0], self.mesh, "model")].clone()
        return full

    def put_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """This rank's part of a host batch; the stacked [K, B, ...] layout
        splits its second dim. Under sp its slice of the points where the
        model takes sharded inputs; under pp the whole batch."""
        dim = 1 if np.ndim(batch["points"]) == 4 else 0
        if self.mode == "sp":
            return SP.shard_sp_batch(batch, self.mesh, self.axis, None, self.shard_inputs, dim,
                                     self.device)
        if self.mode == "pp":
            return batch_to_device(batch, self.device)
        axis = "data" if self.mode in ("tp", "ep") else self.axis
        return shard_batch(batch, self.mesh, axis, dim, self.device)

    def full_model_state(self, model) -> Dict[str, torch.Tensor]:
        """The model's state_dict in the single-device layout (a collective:
        every rank calls it)."""
        if self.mode == "fsdp":
            return F.full_state_dict(model)
        if self.mode == "pp":
            return self._stages.full_state()
        return self.full_tensors(model, model.state_dict())

    def full_tensors(self, model, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if self.mode == "fsdp":
            return F.full_tensors(tensors)
        if self.mode == "pp":
            return self._stages.full_tensors(tensors)
        if self.mode == "ep":
            return E.full_tensors(model, self.mesh, tensors)
        return S.full_tensors(model, tensors, self.mesh) if self.mode == "tp" else tensors

    def full_optimizer_state(self, model, optimizer) -> dict:
        if self.mode == "fsdp":
            return F.full_fsdp_optimizer_state(model, optimizer)
        if self.mode == "pp":
            return self._stages.full_optimizer_state(optimizer)
        if self.mode in ("tp", "ep"):
            if self.mode == "tp":
                shard = S.param_shardings(model, self.mesh)
                group = self.mesh.get_group("model")
            else:
                shard = E.ep_state_shardings(model)
                group = self.mesh.get_group("expert")
            names = {id(p): k for k, p in model.named_parameters()}
            return S.full_optimizer_state(
                model, optimizer,
                lambda p, v: S.gather_plain(v, group) if shard.get(names[id(p)]) else v)
        return optimizer.state_dict()
