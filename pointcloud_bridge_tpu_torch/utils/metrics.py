"""Segmentation metrics from confusion matrices (counterpart of
pointcloud_bridge_tpu/utils/metrics.py:19-72, which imports JAX).

Formula parity with Highway_bridge/inference.py:814-855: per-class IoU and
mIoU, OA, per-class accuracy and mAcc, row-weighted precision and recall,
F1 = 2PR/(P+R).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def confusion_matrix(
    preds: torch.Tensor, labels: torch.Tensor, num_classes: int
) -> torch.Tensor:
    """[C, C] int64 counts, rows = true label, columns = prediction, on the
    tensors' device."""
    flat = labels.reshape(-1).long() * num_classes + preds.reshape(-1).long()
    counts = torch.bincount(flat, minlength=num_classes * num_classes)
    return counts.reshape(num_classes, num_classes)


def metrics_from_confusion(cm) -> Dict[str, object]:
    """The inference.py:814-855 metric suite from a [C, C] confusion matrix
    (numpy array or tensor)."""
    if isinstance(cm, torch.Tensor):
        cm = cm.cpu().numpy()
    cm = np.asarray(cm, np.float64)
    diag = np.diag(cm)
    union = cm.sum(axis=1) + cm.sum(axis=0) - diag
    iou_per_class = diag / (union + 1e-6)
    total = cm.sum()
    acc_per_class = diag / (cm.sum(axis=1) + 1e-6)
    precision_per_class = diag / (cm.sum(axis=0) + 1e-6)
    weights = cm.sum(axis=1) / max(total, 1e-6)
    precision = float((precision_per_class * weights).sum())
    recall = float((acc_per_class * weights).sum())
    f1 = 2 * precision * recall / (precision + recall + 1e-6)
    return {
        "mIoU": float(np.nanmean(iou_per_class)),
        "IoU_per_class": iou_per_class,
        "OA": float(diag.sum() / max(total, 1e-6)),
        "mAcc": float(np.nanmean(acc_per_class)),
        "Acc_per_class": acc_per_class,
        "Precision": precision,
        "Recall": recall,
        "F1_score": float(f1),
        "Confusion_Matrix": cm,
    }
