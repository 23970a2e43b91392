"""Device-mesh parallelism of the port on ``torch.distributed``
(counterpart of pointcloud_bridge_tpu/parallel/, part 1).

One rank a device: ``torchrun`` starts them on the card (NCCL), a test's
spawn on the CPU (gloo). ``mesh.py`` builds the meshes and places the
batch; ``train_step.py`` is data parallelism with sync-BN (train,
multi-step and eval steps); ``sharding.py`` tensor parallelism over a
("data", "model") mesh; ``fsdp.py`` FSDP over the "data" mesh. Sequence,
pipeline and expert parallelism (the JAX package's ``sp.py``, ``ring.py``,
``pp.py``, ``ep.py``) are ROADMAP.md's "Parallel layer, part 2".
"""

from .fsdp import fsdp_state_shardings, make_fsdp_mesh, make_fsdp_train_step
from .mesh import make_mesh, make_named_mesh, replicate, shard_batch
from .sharding import make_2d_mesh, make_tp_train_step, param_shardings, state_shardings
from .train_step import (
    make_dp_eval_step,
    make_dp_multi_train_step,
    make_dp_train_step,
    rank_seed,
)

__all__ = [
    "fsdp_state_shardings",
    "make_2d_mesh",
    "make_dp_eval_step",
    "make_dp_multi_train_step",
    "make_dp_train_step",
    "make_fsdp_mesh",
    "make_fsdp_train_step",
    "make_mesh",
    "make_named_mesh",
    "make_tp_train_step",
    "param_shardings",
    "rank_seed",
    "replicate",
    "shard_batch",
    "state_shardings",
]
