"""Training CLI of the port (counterpart of pointcloud_bridge_tpu/train_cli.py,
with the same flags and ``--device``).

Usage:
    python -m pointcloud_bridge_tpu_torch.train_cli --config config.yaml
    python -m pointcloud_bridge_tpu_torch.train_cli --train-dir data/train \\
        --val-dir data/val --num-classes 5 --loss weighted_ce

Trains on the first CUDA device; without one it stops with an error.
``--device cpu`` runs the plain PyTorch ops on the CPU and is meant for
tests.

On a mesh (the config's ``parallel: {num_devices: -1, mode: dp}``, or tp,
fsdp, sp, pp or ep) one process a GPU, started by torchrun, which sets
the ranks' environment; the CLI opens the process group (NCCL, or gloo
with ``--device cpu``) and closes it at the end:
    torchrun --nproc_per_node 4 -m pointcloud_bridge_tpu_torch.train_cli \
        --config dp.yaml --train-dir data/train
"""

from __future__ import annotations

import argparse
import glob
import os


def build_datasets(cfg):
    from .data import BlockDataset

    def files_of(d):
        out = []
        for pat in ("*.las", "*.h5", "*.hdf5"):
            out.extend(glob.glob(os.path.join(d, pat)))
        return sorted(out)

    train_files = files_of(cfg.data.train_dir)
    if not train_files:
        raise FileNotFoundError(f"no LAS/H5 scenes in {cfg.data.train_dir}")
    tr = BlockDataset.from_files(
        train_files,
        num_points=cfg.data.num_points,
        block_size=cfg.data.block_size,
        sample_rate=cfg.data.sample_rate,
        num_classes=cfg.model.num_classes,
        weighted=cfg.data.weighted_sampling,
        sampler=cfg.data.sampler,
        chunk_size=cfg.data.chunk_size,
        overlap=cfg.data.overlap,
        steps_per_file=cfg.data.steps_per_file,
        cache_dir=cfg.data.cache_dir,
        augment=cfg.data.augment,
        seed=cfg.train.seed,
    )
    va = None
    if cfg.data.val_dir:
        val_files = files_of(cfg.data.val_dir)
        if val_files:
            va = BlockDataset.from_files(
                val_files,
                num_points=cfg.data.num_points,
                block_size=cfg.data.block_size,
                sample_rate=cfg.data.sample_rate,
                num_classes=cfg.model.num_classes,
                sampler=cfg.data.sampler,
                chunk_size=cfg.data.chunk_size,
                overlap=cfg.data.overlap,
                steps_per_file=cfg.data.steps_per_file,
                cache_dir=cfg.data.cache_dir,
                seed=cfg.train.seed + 999,
            )
    return tr, va


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="train a bridge segmentation model (PyTorch)")
    ap.add_argument("--config", help="YAML config (reference config.yaml keys)")
    ap.add_argument("--model", default=None)
    ap.add_argument("--train-dir", default=None)
    ap.add_argument("--val-dir", default=None)
    ap.add_argument("--num-classes", type=int, default=None)
    ap.add_argument("--num-points", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--num-epochs", type=int, default=None)
    ap.add_argument("--learning-rate", type=float, default=None)
    ap.add_argument("--loss", default=None,
                    choices=["ce", "weighted_ce", "bridge_structure", "sol"])
    ap.add_argument("--scheduler", default=None,
                    choices=["plateau", "cosine", "step", "none"])
    ap.add_argument("--weighted-sampling", action="store_true")
    ap.add_argument("--sampler", default=None,
                    choices=["stratified", "weighted", "random", "simple", "chunked"])
    ap.add_argument("--case", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; an error without a card) or cpu (tests)")
    args = ap.parse_args(argv)

    from .config import Config

    cfg = Config.from_yaml(args.config) if args.config else Config()
    for flag, (sub, attr) in {
        "model": ("model", "name"),
        "train_dir": ("data", "train_dir"),
        "val_dir": ("data", "val_dir"),
        "num_classes": ("model", "num_classes"),
        "num_points": ("data", "num_points"),
        "batch_size": ("train", "batch_size"),
        "num_epochs": ("train", "num_epochs"),
        "learning_rate": ("train", "learning_rate"),
        "loss": ("loss", "name"),
        "scheduler": ("train", "scheduler"),
        "sampler": ("data", "sampler"),
    }.items():
        if getattr(args, flag):
            setattr(getattr(cfg, sub), attr, getattr(args, flag))
    if args.weighted_sampling:
        cfg.data.weighted_sampling = True
    if args.case:
        cfg.case = args.case
    cfg.device = args.device

    from .train import train
    from .train.loop import resolve_device

    resolve_device(cfg.device)  # no card: fail before reading any data
    grouped = int(os.environ.get("WORLD_SIZE", "1")) > 1 and open_process_group(cfg.device)
    try:
        tr, va = build_datasets(cfg)
        out = train(cfg, tr, va)
    finally:
        if grouped:
            import torch.distributed as dist

            dist.destroy_process_group()
    if out["exp_dir"] and int(os.environ.get("RANK", "0")) == 0:
        print(f"done: best_val_acc={out['best_val_acc']:.4f} exp_dir={out['exp_dir']}")
    return out


def open_process_group(device: str) -> bool:
    """The default process group of a torchrun launch (its environment:
    RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT): NCCL on the
    rank's card, gloo when the caller asked for the CPU."""
    import torch
    import torch.distributed as dist

    if device == "cpu":
        dist.init_process_group("gloo")
    else:
        local = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", device_id=local)
    return True


if __name__ == "__main__":
    main()
