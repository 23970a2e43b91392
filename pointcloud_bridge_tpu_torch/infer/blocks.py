"""Block inference with per-file and global metrics (counterpart of
pointcloud_bridge_tpu/infer/blocks.py).

Mirrors Highway_bridge/inference.py: a batched eval forward over the
dataset's blocks, confusion matrices keyed by source file, the metric suite,
and CSV export.
"""

from __future__ import annotations

import csv
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..utils import metrics as M


def run_block_inference(
    model: torch.nn.Module,
    dataset,
    num_classes: int,
    batch_size: int = 16,
    device: torch.device | str = "cpu",
) -> Dict[str, Any]:
    """Returns {global: metrics, per_file: {name: metrics}, predictions:
    [NB, P] int32 in dataset block order}.

    ``model`` must already be on ``device``; it is put in eval mode. Each
    batch of ``dataset.points`` / ``dataset.colors`` is copied to the device
    on its own, and the predictions are fetched once at the end. The last
    batch re-runs the last ``batch_size`` blocks when the count does not
    divide (the JAX version's overlapping tail slice). On CUDA this sets
    ``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32`` to False: the port computes in full
    float32.
    """
    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    model.eval()
    nb_total = len(dataset)
    p = dataset.num_points
    bsz = min(batch_size, nb_total)

    preds_all = np.zeros((nb_total, p), np.int32)
    if nb_total:
        starts = list(range(0, nb_total - bsz + 1, bsz))
        if starts[-1] + bsz < nb_total:
            starts.append(nb_total - bsz)  # overlapping tail batch
        outs = []
        with torch.inference_mode():
            for s in starts:
                xyz = torch.from_numpy(
                    np.ascontiguousarray(dataset.points[s : s + bsz], np.float32)
                ).to(device)
                cols = torch.from_numpy(
                    np.ascontiguousarray(dataset.colors[s : s + bsz], np.float32)
                ).to(device)
                outs.append(model(xyz, cols).argmax(-1).to(torch.int32))
            fetched = torch.stack(outs).cpu().numpy()  # one fetch
        for j, s in enumerate(starts):
            preds_all[s : s + bsz] = fetched[j]

    # per-file and global confusion matrices in one bincount over
    # (file, label, prediction) keys
    labels = np.asarray(dataset.labels, np.int64)  # [NB, P]
    file_ids = np.asarray(dataset.file_ids, np.int64)  # [NB]
    nf = len(dataset.file_names)
    key = (
        file_ids[:, None] * (num_classes * num_classes)
        + labels * num_classes
        + preds_all
    )
    per_file = np.bincount(
        key.ravel(), minlength=nf * num_classes * num_classes
    ).reshape(nf, num_classes, num_classes)
    per_file_cm: Dict[str, np.ndarray] = {}
    for fi, fname in enumerate(dataset.file_names):
        if per_file[fi].sum():
            per_file_cm[fname] = per_file_cm.get(
                fname, np.zeros((num_classes, num_classes), np.int64)
            ) + per_file[fi]

    return {
        "global": M.metrics_from_confusion(per_file.sum(axis=0)),
        "per_file": {
            k: M.metrics_from_confusion(v) for k, v in per_file_cm.items()
        },
        "predictions": preds_all,
    }


def save_metrics_csv(
    results: Dict[str, Any], out_dir: str, class_names: Optional[list] = None
) -> str:
    """Write global + per-file metric CSVs and the global confusion matrix
    (inference.py:331-373 contract). Returns the metrics CSV's path."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "metrics.csv")

    def row_for(name: str, m: Dict[str, Any]) -> Dict[str, Any]:
        r = {
            "file": name,
            "mIoU": m["mIoU"],
            "OA": m["OA"],
            "mAcc": m["mAcc"],
            "Precision": m["Precision"],
            "Recall": m["Recall"],
            "F1_score": m["F1_score"],
        }
        for c, iou in enumerate(m["IoU_per_class"]):
            cname = class_names[c] if class_names else f"class_{c}"
            r[f"IoU_{cname}"] = float(iou)
        return r

    rows = [row_for("GLOBAL", results["global"])]
    for fname, m in sorted(results["per_file"].items()):
        rows.append(row_for(fname, m))
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)

    cm_path = os.path.join(out_dir, "confusion_matrix.csv")
    np.savetxt(
        cm_path, results["global"]["Confusion_Matrix"], fmt="%d", delimiter=","
    )
    return path
