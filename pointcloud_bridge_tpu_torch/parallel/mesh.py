"""Device meshes over the ranks of ``torch.distributed`` and the batch's
place on them (counterpart of pointcloud_bridge_tpu/parallel/mesh.py).

JAX runs one process over N devices; here each device is a rank of its
own, started by ``torchrun`` on the card (NCCL, a rank's device
``cuda:<LOCAL_RANK>``) or by a test's spawn on the CPU (gloo), and the
default process group must be initialised before a mesh is made. A mesh is
a ``DeviceMesh`` over the whole world; building it binds each of its named
axes to this rank's process group along that axis
(utils/collectives.py), where the models' sync-BN and the steps find it.
Every rank holds the whole host batch; :func:`shard_batch` keeps its rows.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..train.loop import batch_to_device
from ..utils.collectives import bind_mesh_axes


def world_size() -> int:
    """The default group's size; an error when none is initialised."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no process group: start the ranks with torchrun (NCCL on the card) "
            "or call torch.distributed.init_process_group first")
    return dist.get_world_size()


def make_named_mesh(shape: Sequence[int], axes: Sequence[str]) -> DeviceMesh:
    """N-D mesh over the whole world, its ranks in row-major order, e.g.
    ``make_named_mesh((2, 2), ("data", "model"))``. The product of
    ``shape`` must be the world's size. Its device type is the default
    backend's: "cuda" under NCCL, "cpu" under gloo (whose ranks may still
    hold CUDA tensors: ``shard_batch`` takes the device)."""
    world = world_size()
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) != world:
        raise ValueError(f"a mesh of shape {shape} over a world of {world} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = init_device_mesh(device_type, shape, mesh_dim_names=tuple(axes))
    bind_mesh_axes(tuple(axes), {a: mesh.get_group(a) for a in axes}, dist.group.WORLD)
    return mesh


def make_mesh(num_devices: int = 0, axis: str = "data") -> DeviceMesh:
    """1-D mesh over the world. ``num_devices`` 0 or -1 means the world;
    any other count must equal it (a rank cannot leave the world)."""
    world = world_size()
    if num_devices not in (0, -1) and num_devices != world:
        raise ValueError(f"a mesh of {num_devices} devices over a world of {world} ranks")
    return make_named_mesh((world,), (axis,))


def rank_rows(n: int, mesh: DeviceMesh, axis: str = "data") -> slice:
    """This rank's rows of ``n`` along the mesh axis ``axis``."""
    size, index = mesh.size(mesh.mesh_dim_names.index(axis)), mesh.get_local_rank(axis)
    if n % size:
        raise ValueError(f"a batch of {n} does not split over the {size} ranks of '{axis}'")
    return slice(index * n // size, (index + 1) * n // size)


def shard_batch(batch: Dict[str, Any], mesh: DeviceMesh, axis: str = "data",
                dim: int = 0, device=None) -> Dict[str, torch.Tensor]:
    """This rank's rows of the global host batch, on ``device`` (the mesh's:
    ``cuda:<current device>`` or the CPU). ``dim=1`` is the stacked
    ``[K, B, ...]`` layout of multi-step dispatch: the K step slots stay
    whole, B splits."""
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if mesh.device_type == "cuda" else torch.device("cpu"))
    rows = rank_rows(np.shape(batch["points"])[dim], mesh, axis)
    index = (slice(None),) * dim + (rows,)
    return batch_to_device({k: np.asarray(v)[index] for k, v in batch.items()}, device)


def replicate(model: torch.nn.Module, optimizer: Optional[torch.optim.Optimizer] = None,
              tensors: Sequence[torch.Tensor] = (), src: int = 0) -> None:
    """Broadcast rank ``src``'s parameters, buffers, optimizer state and
    ``tensors`` (the EMA weights) to every rank, in place. Every rank must
    hold the same structure: the same model, and optimizer state for the
    same parameters."""
    world_size()
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()) + list(tensors):
            dist.broadcast(t.data, src=src)
        if optimizer is not None:
            for p in model.parameters():
                for v in optimizer.state.get(p, {}).values():
                    # the eager Adam's step count stays on the host, the same
                    # on every rank: NCCL moves device tensors alone
                    if torch.is_tensor(v) and v.device == p.device:
                        dist.broadcast(v, src=src)
