"""Inference CLI of the port (counterpart of pointcloud_bridge_tpu/infer_cli.py,
with the same modes and flags, and ``--device``).

Modes:
  blocks: block-based inference over the scenes' blocks with per-file
    metrics, CSVs and figures.
  scene: whole-scene sliding-grid K-vote inference per LAS/H5 file with
    per-scene IoU and predicted-LAS export.

Usage:
    python -m pointcloud_bridge_tpu_torch.infer_cli blocks \\
        --checkpoint experiments/<run> --data-dir data/val
    python -m pointcloud_bridge_tpu_torch.infer_cli scene --model bristrunet \\
        --checkpoint experiments/<run> --data-dir data/val --num-votes 5 --export-las

``--checkpoint`` is an experiment directory (its ``best_model`` is taken,
else its ``latest_checkpoint``) or a checkpoint file of
``utils/checkpoint.py``. Runs on the first CUDA device; without one it stops
with an error. ``--device cpu`` runs the plain PyTorch ops and is meant for
tests.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="run segmentation inference (PyTorch)")
    ap.add_argument("mode", choices=["blocks", "scene"])
    ap.add_argument("--checkpoint", required=True, help="experiment dir or checkpoint file")
    ap.add_argument("--model", default="pointnet2_ssg")
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--out-dir", default="inference_results")
    ap.add_argument("--num-classes", type=int, default=5)
    ap.add_argument("--num-points", type=int, default=4096)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--num-votes", type=int, default=5)
    ap.add_argument("--block-size", type=float, default=1.0)
    ap.add_argument("--stride", type=float, default=0.5)
    ap.add_argument("--export-las", action="store_true")
    ap.add_argument("--save-subplots", action="store_true",
                    help="export each figure panel as its own PNG/PDF")
    ap.add_argument("--normalize-scene", action="store_true",
                    help="whole-scene normalization (Highway training contract)")
    ap.add_argument("--from-snapshot", action="store_true",
                    help="import model code from the experiment's "
                         "code_snapshot dir, so that results don't drift "
                         "when the working tree moves on")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; an error without a card) or cpu (tests)")
    args = ap.parse_args(argv)

    from .train.loop import resolve_device
    from .utils.checkpoint import restore_checkpoint

    device = resolve_device(args.device)  # no card: fail before reading any data
    if args.from_snapshot:
        from .utils.logging import load_snapshot_models

        get_model = load_snapshot_models(args.checkpoint)
    else:
        from .models import get_model

    ckpt = args.checkpoint
    for cand in ("best_model", "latest_checkpoint"):
        p = os.path.join(args.checkpoint, cand)
        if os.path.exists(p):
            ckpt = p
            break
    model = get_model(args.model, num_classes=args.num_classes)
    model.load_state_dict(restore_checkpoint(ckpt)["model"], strict=True)
    model.to(device)

    os.makedirs(args.out_dir, exist_ok=True)
    scenes = sorted(
        glob.glob(os.path.join(args.data_dir, "*.las"))
        + glob.glob(os.path.join(args.data_dir, "*.h5"))
    )

    if args.mode == "blocks":
        from .data import BlockDataset
        from .infer import run_block_inference, save_metrics_csv
        from .infer.figures import file_comparison_charts, save_inference_figures

        ds = BlockDataset.from_files(
            scenes, num_points=args.num_points, num_classes=args.num_classes
        )
        res = run_block_inference(model, ds, args.num_classes, args.batch_size)
        save_metrics_csv(res, args.out_dir)
        try:
            save_inference_figures(res, args.out_dir, save_subplots=args.save_subplots)
            if res.get("per_file"):
                file_comparison_charts(res["per_file"], args.out_dir)
        except Exception as e:  # figures are an extra; the metrics are written
            print(f"figure generation failed: {e}")
        g = res["global"]
        print(
            f"GLOBAL mIoU={g['mIoU']:.4f} OA={g['OA']:.4f} mAcc={g['mAcc']:.4f} "
            f"F1={g['F1_score']:.4f}"
        )
    else:
        from .data import scene_labelweights
        from .data.dataset import _load_scene
        from .infer import export_predicted_las, whole_scene_vote_predict
        from .utils.metrics import metrics_from_confusion

        loaded = [(f, *_load_scene(f)) for f in scenes]
        lw = scene_labelweights([labels for _, _, _, labels in loaded], args.num_classes)
        total_cm = np.zeros((args.num_classes, args.num_classes))
        for f, pts, cols, labels in loaded:
            pts6 = np.concatenate([pts, cols], axis=1)
            res = whole_scene_vote_predict(
                model, pts6, labels, lw, args.num_classes,
                block_points=args.num_points, block_size=args.block_size,
                stride=args.stride, num_votes=args.num_votes,
                batch_size=args.batch_size,
                normalize_scene=args.normalize_scene,
            )
            m = res["metrics"]
            total_cm += m["Confusion_Matrix"]
            print(f"{os.path.basename(f)}: mIoU={m['mIoU']:.4f} OA={m['OA']:.4f}")
            if args.export_las:
                out = os.path.join(
                    args.out_dir,
                    os.path.basename(f).replace(".las", "").replace(".h5", "")
                    + "_pred.las",
                )
                export_predicted_las(out, pts, cols, res["pred"])
        g = metrics_from_confusion(total_cm)
        print(f"OVERALL mIoU={g['mIoU']:.4f} OA={g['OA']:.4f}")


if __name__ == "__main__":
    main()
