"""One typed config for the whole framework (the port's own copy of
pointcloud_bridge_tpu/config.py: the same keys and defaults, so that one
YAML file drives either package).

The reference scatters configuration across inline dicts, config.yaml, a dead
dataclass schema, argparse and class-based Config (SURVEY.md §5 'Config/flag
system'). We honor the same YAML keys (Highway_bridge/config.yaml:1-13:
num_points, chunk_size, overlap, batch_size, num_workers, learning_rate,
num_classes, num_epochs, device, case, train_dir, val_dir, exp_dir_root) in a
single dataclass tree.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence


@dataclass
class DataConfig:
    train_dir: str = ""
    val_dir: str = ""
    num_points: int = 4096
    block_size: float = 1.0
    sample_rate: float = 0.5
    chunk_size: int = 4096  # chunked loaders (data_utils_ver2.py:16)
    overlap: int = 1024
    weighted_sampling: bool = False
    sampler: str = "stratified"  # stratified|weighted|random|simple|chunked
    steps_per_file: int = 10  # 'simple' sampler (simpdataset.py)
    augment: bool = True
    cache_dir: Optional[str] = None
    num_workers: int = 0  # host-side; kept for config-key parity


@dataclass
class ModelConfig:
    name: str = "pointnet2_ssg"
    num_classes: int = 5
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class LossConfig:
    name: str = "weighted_ce"  # weighted_ce | ce | bridge_structure | sol
    use_class_weights: bool = True
    label_smoothing: float = 0.0
    alpha: float = 80.0  # BridgeStructureLoss (train_MulSca_BriStruNet_CB.py:151)
    rel_margin: float = 0.3


@dataclass
class TrainConfig:
    batch_size: int = 16
    num_epochs: int = 100
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4  # Adam wd (train_MulSca_PN2.py Adam betas/wd)
    scheduler: str = "plateau"  # plateau | cosine | step | none
    plateau_factor: float = 0.1
    plateau_patience: int = 5
    min_lr: float = 1e-5
    step_decay: float = 0.7  # Partsize: lr * 0.7^(epoch//10) (train.py:201-204)
    step_every: int = 10
    seed: int = 0
    log_every: int = 10
    donate: bool = True
    # async input feed depth: batches converted + device_put on a background
    # thread while the current step runs (DataLoader-workers equivalent;
    # train/loop.py::prefetch_to_device). 0/1 = synchronous.
    prefetch: int = 2
    # gradient accumulation: >1 splits each batch into this many equal
    # microbatches, averages their grads, and applies ONE optimizer update —
    # the effective batch is batch_size with 1/accum_steps of the activation
    # memory. BatchNorm moments are per-microbatch (running stats chain
    # sequentially), the standard accumulation semantics. (In the JAX
    # package the microbatches run as an unrolled python loop inside one jit.)
    accum_steps: int = 1
    # exponential moving average of params (>0 enables; 0.999 typical):
    # ema = d*ema + (1-d)*params after every step (one fused elementwise
    # kernel, stays on device). Validation and the best_model checkpoint use
    # the EMA weights (the deployed set); latest_checkpoint keeps raw params
    # and the EMA tree rides its own latest_ema checkpoint for exact resume.
    ema_decay: float = 0.0
    # linear LR warmup over the first N epochs (multiplier epoch/N, applied
    # on top of whichever scheduler is active; 0 disables). Standard for the
    # transformer models (ptv3); the reference has no warmup.
    warmup_epochs: int = 0
    # >1 runs this many FULL optimizer steps per jit dispatch on a stacked
    # batch (one enqueue + one K-sized H2D upload instead of K of each) —
    # exactly K sequential steps by construction, per-step metrics
    # preserved, EMA applied per inner step. Single-device engine only;
    # mutually exclusive with accum_steps. See train/loop.py::
    # make_multi_train_step for why (dispatch amortization).
    steps_per_dispatch: int = 1


@dataclass
class ParallelConfig:
    data_axis: str = "data"
    num_devices: int = 0  # 0 = all available
    dtype: str = "float32"  # compute dtype for the model ("bfloat16" on TPU)
    # "dp" = data parallelism (batch sharded); "sp" = sequence parallelism
    # (the N point axis sharded: ring attention for global-attention PTv3,
    # query-axis sharding for the neighborhood models / windowed PTv3 —
    # parallel/sp.py); "fsdp" = ZeRO-3 (params + optimizer moments sharded
    # over the data axis alongside the batch — parallel/fsdp.py); "pp" =
    # pipeline parallelism (the ptv3 family's homogeneous block stack
    # stage-sharded, GPipe microbatch schedule — parallel/pp.py;
    # checkpoints stay in the canonical single-device layout). All
    # engage only when num_devices requests a mesh.
    mode: str = "dp"
    # SP input contract: -1 = infer from the model (ptv3-family with global
    # attention shards inputs over N; everything else uses the
    # shard_inputs=False full-input contract); 0/1 force.
    sp_shard_inputs: int = -1
    # GPipe microbatches per step for mode="pp" (0 = one per stage);
    # batch_size must divide it. Bubble fraction is (P-1)/(M+P-1).
    pp_microbatches: int = 0
    # mode="tp": size of the model axis on the ("data", "model") mesh
    # (num_devices must divide it; the batch shards over the data axis) —
    # parallel/sharding.py column-parallel Dense kernels via GSPMD.
    tp_axis_size: int = 2
    # mode="ep": size of the expert axis on the ("data", "expert") mesh
    # (experts_* param leaves shard their leading E axis — parallel/ep.py;
    # the MoE model family), and the router load-balance aux-loss weight.
    ep_axis_size: int = 2
    ep_aux_coef: float = 1e-2


@dataclass
class Config:
    case: str = "default"
    exp_dir_root: str = "experiments"
    device: str = "auto"  # kept for key parity; JAX picks the backend
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        """Build from a (possibly flat, reference-style) dict.

        Flat reference keys (num_points, batch_size, learning_rate, ...) are
        routed to the right sub-config; nested dicts override directly.
        """
        cfg = cls()
        flat_routes = {
            "num_points": ("data", "num_points"),
            "block_size": ("data", "block_size"),
            "sample_rate": ("data", "sample_rate"),
            "chunk_size": ("data", "chunk_size"),
            "overlap": ("data", "overlap"),
            "num_workers": ("data", "num_workers"),
            "train_dir": ("data", "train_dir"),
            "val_dir": ("data", "val_dir"),
            "batch_size": ("train", "batch_size"),
            "num_epochs": ("train", "num_epochs"),
            "learning_rate": ("train", "learning_rate"),
            "num_classes": ("model", "num_classes"),
            "model": ("model", "name"),
        }
        for k, v in d.items():
            if k in ("case", "exp_dir_root", "device"):
                setattr(cfg, k, v)
            elif k == "model_extra" and isinstance(v, dict):
                cfg.model.extra.update(v)
            elif k == "loss" and isinstance(v, str):
                cfg.loss.name = v
            elif k in flat_routes:
                sub, attr = flat_routes[k]
                setattr(getattr(cfg, sub), attr, v)
            elif k in ("data", "model", "loss", "train", "parallel") and isinstance(
                v, dict
            ):
                sub = getattr(cfg, k)
                for kk, vv in v.items():
                    if hasattr(sub, kk):
                        setattr(sub, kk, vv)
        return cfg

    @classmethod
    def from_yaml(cls, path: str) -> "Config":
        import yaml

        with open(path) as f:
            return cls.from_dict(yaml.safe_load(f) or {})

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)
