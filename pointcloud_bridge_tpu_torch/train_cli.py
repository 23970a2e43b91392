"""Training CLI of the port (counterpart of pointcloud_bridge_tpu/train_cli.py,
with the same flags and ``--device``).

Usage:
    python -m pointcloud_bridge_tpu_torch.train_cli --config config.yaml
    python -m pointcloud_bridge_tpu_torch.train_cli --train-dir data/train \\
        --val-dir data/val --num-classes 5 --loss weighted_ce

Trains on the first CUDA device; without one it stops with an error.
``--device cpu`` runs the plain PyTorch ops on the CPU and is meant for
tests. The datasets and the config are the JAX package's, shared: neither
imports JAX.
"""

from __future__ import annotations

import argparse


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

    from pointcloud_bridge_tpu.train_cli import build_datasets

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
    tr, va = build_datasets(cfg)
    out = train(cfg, tr, va)
    print(f"done: best_val_acc={out['best_val_acc']:.4f} exp_dir={out['exp_dir']}")
    return out


if __name__ == "__main__":
    main()
