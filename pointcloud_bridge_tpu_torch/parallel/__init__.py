"""Device-mesh parallelism of the port on ``torch.distributed``
(counterpart of pointcloud_bridge_tpu/parallel/).

One rank a device: ``torchrun`` starts them on the card (NCCL), a test's
spawn on the CPU (gloo). ``mesh.py`` builds the meshes and places the
batch; ``train_step.py`` is data parallelism with sync-BN (train,
multi-step and eval steps); ``sharding.py`` tensor parallelism over a
("data", "model") mesh; ``fsdp.py`` FSDP over the "data" mesh; ``ring.py``
and ``sp.py`` sequence parallelism over the point axis, global attention as
ring attention on the flash-attention kernels; ``pp.py`` GPipe pipeline
parallelism over PTv3's block stack; ``ep.py`` expert parallelism over a
("data", "expert") mesh. The collectives that carry a gradient are in
utils/collectives.py.
"""

from .ep import ep_state_shardings, make_ep_mesh, make_ep_train_step
from .fsdp import fsdp_state_shardings, make_fsdp_mesh, make_fsdp_train_step
from .mesh import make_mesh, make_named_mesh, replicate, shard_batch
from .pp import (
    make_pp_eval_step,
    make_pp_forward,
    make_pp_state,
    make_pp_train_step,
    pp_place_state,
    pp_stack_state,
    pp_state_specs,
    pp_unstack_state,
    stack_ptv3_params,
    unstack_ptv3_params,
)
from .ring import ring_attention, ring_attention_plain
from .sharding import make_2d_mesh, make_tp_train_step, param_shardings, state_shardings
from .sp import (
    make_sp_eval_step,
    make_sp_forward,
    make_sp_multi_train_step,
    make_sp_train_step,
    shard_sp_batch,
)
from .train_step import (
    make_dp_eval_step,
    make_dp_multi_train_step,
    make_dp_train_step,
    rank_seed,
)

__all__ = [
    "ep_state_shardings",
    "fsdp_state_shardings",
    "make_2d_mesh",
    "make_dp_eval_step",
    "make_dp_multi_train_step",
    "make_dp_train_step",
    "make_ep_mesh",
    "make_ep_train_step",
    "make_fsdp_mesh",
    "make_fsdp_train_step",
    "make_mesh",
    "make_named_mesh",
    "make_pp_eval_step",
    "make_pp_forward",
    "make_pp_state",
    "make_pp_train_step",
    "make_sp_eval_step",
    "make_sp_forward",
    "make_sp_multi_train_step",
    "make_sp_train_step",
    "make_tp_train_step",
    "param_shardings",
    "pp_place_state",
    "pp_stack_state",
    "pp_state_specs",
    "pp_unstack_state",
    "rank_seed",
    "replicate",
    "ring_attention",
    "ring_attention_plain",
    "shard_batch",
    "shard_sp_batch",
    "stack_ptv3_params",
    "state_shardings",
    "unstack_ptv3_params",
]
