"""Inference result figures — the visualize_results suite
(inference.py:408-785): per-class IoU/accuracy bars, confusion-matrix heatmap,
per-file metric comparison, and a metric summary panel. PNG + PDF like the
reference."""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np


def _save_both(fig, out_dir: str, stem: str, paths: List[str]) -> None:
    import matplotlib.pyplot as plt

    for ext in ("png", "pdf"):
        p = os.path.join(out_dir, f"{stem}.{ext}")
        fig.savefig(p, dpi=200 if ext == "png" else None, bbox_inches="tight")
        paths.append(p)
    plt.close(fig)


def save_inference_figures(
    results: Dict[str, Any],
    out_dir: str,
    class_names: Optional[List[str]] = None,
    save_subplots: bool = False,
    prefix: str = "",
) -> List[str]:
    """6-panel summary figure; with `save_subplots` each panel is also
    exported as its own PNG + PDF (inference.py:408-659 save_subplots)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    g = results["global"]
    c = len(g["IoU_per_class"])
    names = class_names or [f"class_{i}" for i in range(c)]
    paths = []

    # 6-panel summary (inference.py:408-659)
    fig, axes = plt.subplots(2, 3, figsize=(16, 9))
    axes[0, 0].bar(names, g["IoU_per_class"])
    axes[0, 0].set_title(f"IoU per class (mIoU={g['mIoU']:.3f})")
    axes[0, 1].bar(names, g["Acc_per_class"])
    axes[0, 1].set_title(f"Accuracy per class (mAcc={g['mAcc']:.3f})")
    cm = np.asarray(g["Confusion_Matrix"], np.float64)
    cmn = cm / np.maximum(cm.sum(axis=1, keepdims=True), 1.0)
    im = axes[0, 2].imshow(cmn, cmap="Blues", vmin=0, vmax=1)
    axes[0, 2].set_title("Confusion matrix (row-normalized)")
    axes[0, 2].set_xticks(range(c), names, rotation=45)
    axes[0, 2].set_yticks(range(c), names)
    fig.colorbar(im, ax=axes[0, 2])
    for i in range(c):
        for j in range(c):
            axes[0, 2].text(j, i, f"{cmn[i, j]:.2f}", ha="center", va="center",
                            fontsize=7)
    summary = {
        "mIoU": g["mIoU"], "OA": g["OA"], "mAcc": g["mAcc"],
        "Precision": g["Precision"], "Recall": g["Recall"], "F1": g["F1_score"],
    }
    axes[1, 0].bar(list(summary), list(summary.values()))
    axes[1, 0].set_ylim(0, 1)
    axes[1, 0].set_title("Global metrics")
    # per-file mIoU / OA comparison (inference.py:723-785)
    per_file = results.get("per_file", {})
    if per_file:
        fnames = sorted(per_file)
        axes[1, 1].bar(fnames, [per_file[f]["mIoU"] for f in fnames])
        axes[1, 1].set_title("Per-file mIoU")
        axes[1, 1].tick_params(axis="x", rotation=45)
        axes[1, 2].bar(fnames, [per_file[f]["OA"] for f in fnames])
        axes[1, 2].set_title("Per-file OA")
        axes[1, 2].tick_params(axis="x", rotation=45)
    fig.tight_layout()
    for ext in ("png", "pdf"):
        p = os.path.join(out_dir, f"evaluation_summary.{ext}")
        fig.savefig(p, dpi=200 if ext == "png" else None, bbox_inches="tight")
        paths.append(p)
    plt.close(fig)

    if save_subplots:
        pre = f"{prefix}_" if prefix else ""

        f1, a = plt.subplots(figsize=(8, 6))
        a.bar(names, g["IoU_per_class"])
        a.set_title(f"IoU per class (mIoU={g['mIoU']:.3f})")
        a.tick_params(axis="x", rotation=45)
        _save_both(f1, out_dir, f"{pre}iou_per_class", paths)

        f2, a = plt.subplots(figsize=(8, 6))
        a.bar(names, g["Acc_per_class"])
        a.set_title(f"Accuracy per class (mAcc={g['mAcc']:.3f})")
        a.tick_params(axis="x", rotation=45)
        _save_both(f2, out_dir, f"{pre}acc_per_class", paths)

        f3, a = plt.subplots(figsize=(8, 7))
        im = a.imshow(cmn, cmap="Blues", vmin=0, vmax=1)
        a.set_title("Confusion matrix (row-normalized)")
        a.set_xticks(range(c), names, rotation=45)
        a.set_yticks(range(c), names)
        f3.colorbar(im, ax=a)
        for i in range(c):
            for j in range(c):
                a.text(j, i, f"{cmn[i, j]:.2f}", ha="center", va="center",
                       fontsize=8)
        _save_both(f3, out_dir, f"{pre}confusion_matrix", paths)

        f4, a = plt.subplots(figsize=(8, 6))
        a.bar(list(summary), list(summary.values()))
        a.set_ylim(0, 1)
        a.set_title("Global metrics")
        _save_both(f4, out_dir, f"{pre}global_metrics", paths)

        if per_file:
            fnames = sorted(per_file)
            for key, stem in (("mIoU", "per_file_miou"), ("OA", "per_file_oa")):
                f5, a = plt.subplots(figsize=(8, 6))
                a.bar(fnames, [per_file[fn][key] for fn in fnames])
                a.set_title(f"Per-file {key}")
                a.tick_params(axis="x", rotation=45)
                _save_both(f5, out_dir, f"{pre}{stem}", paths)
    return paths


def file_comparison_charts(
    per_file: Dict[str, Dict[str, Any]],
    out_dir: str,
    class_names: Optional[List[str]] = None,
) -> List[str]:
    """Dedicated per-file comparison charts (inference.py:723-785):
    grouped mIoU/OA/F1 bars per file + class-IoU-by-file heatmap, PNG+PDF."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    paths: List[str] = []
    fnames = sorted(per_file)
    if not fnames:
        return paths
    c = len(per_file[fnames[0]]["IoU_per_class"])
    names = class_names or [f"class_{i}" for i in range(c)]

    # grouped bars: mIoU / OA / F1 per file
    metrics = [("mIoU", "mIoU"), ("OA", "Accuracy"), ("F1_score", "F1 Score")]
    x = np.arange(len(fnames))
    width = 0.25
    fig, ax = plt.subplots(figsize=(max(8, 2 * len(fnames)), 6))
    for i, (key, label) in enumerate(metrics):
        vals = [100 * per_file[f][key] for f in fnames]
        bars = ax.bar(x + (i - 1) * width, vals, width, label=label)
        ax.bar_label(bars, fmt="%.1f%%", fontsize=8)
    ax.set_xticks(x, fnames, rotation=45, ha="right")
    ax.set_ylabel("Percentage (%)")
    ax.set_ylim(0, 110)
    ax.set_title("Performance metrics by file")
    ax.legend()
    ax.grid(axis="y", linestyle="--", alpha=0.7)
    fig.tight_layout()
    _save_both(fig, out_dir, "file_comparison", paths)

    # class-IoU-by-file heatmap
    mat = np.array(
        [[100 * per_file[f]["IoU_per_class"][i] for f in fnames] for i in range(c)]
    )
    fig, ax = plt.subplots(figsize=(max(8, 1.5 * len(fnames)), 6))
    im = ax.imshow(mat, cmap="YlGnBu", vmin=0, vmax=100)
    ax.set_xticks(range(len(fnames)), fnames, rotation=45, ha="right")
    ax.set_yticks(range(c), names)
    for i in range(c):
        for j in range(len(fnames)):
            ax.text(j, i, f"{mat[i, j]:.1f}", ha="center", va="center",
                    fontsize=8)
    fig.colorbar(im, ax=ax, label="IoU (%)")
    ax.set_title("Class IoU by file (%)")
    fig.tight_layout()
    _save_both(fig, out_dir, "class_iou_comparison", paths)
    return paths


def scatter_3d_comparison(
    xyz: np.ndarray,
    gt: np.ndarray,
    pred: np.ndarray,
    out_path: str,
    max_points: int = 50000,
    seed: int = 0,
) -> str:
    """GT-vs-prediction 3D scatter (inference.py:661-721)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rng = np.random.default_rng(seed)
    if len(xyz) > max_points:
        sel = rng.choice(len(xyz), max_points, replace=False)
        xyz, gt, pred = xyz[sel], gt[sel], pred[sel]
    fig = plt.figure(figsize=(14, 6))
    for i, (labels, title) in enumerate([(gt, "Ground truth"), (pred, "Prediction")]):
        ax = fig.add_subplot(1, 2, i + 1, projection="3d")
        ax.scatter(xyz[:, 0], xyz[:, 1], xyz[:, 2], c=labels, s=0.5, cmap="tab10")
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path
