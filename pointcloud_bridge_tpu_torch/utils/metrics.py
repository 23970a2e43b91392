"""Segmentation metrics from confusion matrices (counterpart of
pointcloud_bridge_tpu/utils/metrics.py, which imports JAX), and the text
report of scikit-learn's ``classification_report`` written in numpy.

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
    tensors' device. Counted into a fixed C * C bins with integer adds (no
    ``bincount``, which reads its largest value on the host to size its
    output: a CUDA graph cannot capture that); a label or prediction out of
    range raises."""
    flat = labels.reshape(-1).long() * num_classes + preds.reshape(-1).long()
    counts = torch.zeros(num_classes * num_classes, dtype=torch.int64, device=flat.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat))
    return counts.reshape(num_classes, num_classes)


def masked_confusion_matrix(
    preds: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor, num_classes: int
) -> torch.Tensor:
    """Confusion matrix counting only mask==True points (padded batches):
    masked-out points go to an extra bin that is dropped. Fixed-length
    integer counts, as :func:`confusion_matrix`."""
    flat = labels.reshape(-1).long() * num_classes + preds.reshape(-1).long()
    flat = torch.where(mask.reshape(-1), flat, num_classes * num_classes)
    counts = torch.zeros(num_classes * num_classes + 1, dtype=torch.int64, device=flat.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat))
    return counts[:-1].reshape(num_classes, num_classes)


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


def classification_report(
    preds: np.ndarray, labels: np.ndarray, class_names=None
) -> str:
    """scikit-learn's ``classification_report(labels, preds,
    target_names=class_names, zero_division=0)`` as a string, character for
    character (utils/metrics.py:74; tool_utils/model_eva.py:46-107), for
    integer labels: a row a class present in either array (sorted; named
    by ``class_names`` in that order, or by the label), precision, recall,
    F1 (2 tp / (true + predicted)) and support, 0 where a division is by 0;
    then the accuracy, the macro average and the average weighted by
    support. The first column is as wide as the longest name and at least
    "weighted avg"; numbers take 2 digits; where no prediction is right
    the supports print as floats, as scikit-learn's. Like scikit-learn, raises
    ``ValueError`` when ``class_names`` does not name every class present."""
    y_true = np.asarray(labels).reshape(-1)
    y_pred = np.asarray(preds).reshape(-1)
    classes = np.unique(np.concatenate([y_true, y_pred]))
    if class_names is not None and len(classes) != len(class_names):
        raise ValueError(
            "Number of classes, {0}, does not match size of "
            "target_names, {1}. Try specifying the labels "
            "parameter".format(len(classes), len(class_names))
        )
    names = ["%s" % c for c in classes] if class_names is None else list(class_names)
    tp = np.array([np.sum((y_true == c) & (y_pred == c)) for c in classes], np.int64)
    pred_sum = np.array([np.sum(y_pred == c) for c in classes], np.int64)
    true_sum = np.array([np.sum(y_true == c) for c in classes], np.int64)
    if not tp.any():  # scikit-learn counts in float64 then: a support prints as "4.0"
        tp, pred_sum, true_sum = (x.astype(np.float64) for x in (tp, pred_sum, true_sum))

    def divide(num, den):
        den = np.asarray(den, np.float64)
        zero = den == 0
        out = np.asarray(num, np.float64) / np.where(zero, 1.0, den)
        out[zero] = 0.0
        return out

    def scores(tp, pred, true):
        return (divide(tp, pred), divide(tp, true),
                divide(2.0 * tp.astype(np.float64), 1.0 * true.astype(np.float64)
                       + pred.astype(np.float64)))

    p, r, f1 = scores(tp, pred_sum, true_sum)
    digits = 2
    width = max(max(len(cn) for cn in names), len("weighted avg"), digits)
    headers = ["precision", "recall", "f1-score", "support"]
    report = ("{:>{width}s} " + " {:>9}" * len(headers)).format("", *headers, width=width)
    report += "\n\n"
    row_fmt = "{:>{width}s} " + " {:>9.{digits}f}" * 3 + " {:>9}\n"
    for row in zip(names, p, r, f1, true_sum):
        report += row_fmt.format(*row, width=width, digits=digits)
    report += "\n"
    support = np.sum(true_sum)
    micro = scores(tp.sum().reshape(1), pred_sum.sum().reshape(1), true_sum.sum().reshape(1))
    report += ("{:>{width}s} " + " {:>9.{digits}}" * 2 + " {:>9.{digits}f}" + " {:>9}\n").format(
        "accuracy", "", "", float(micro[2][0]), support, width=width, digits=digits)
    for heading, weights in (("macro avg", None), ("weighted avg", true_sum)):
        avg = [float(np.average(x, weights=weights)) for x in (p, r, f1)]
        report += row_fmt.format(heading, *avg, support, width=width, digits=digits)
    return report
