"""Segmentation losses (counterpart of pointcloud_bridge_tpu/losses.py).

  - weighted_cross_entropy: CE with per-class weights and label smoothing,
    with the semantics of torch's ``cross_entropy(weight=...,
    label_smoothing=...)``;
  - class_weights_from_counts: inverse-frequency weights clamped to
    [0.5, 3.0];
  - bridge_structure_loss: the z-hierarchy prior {abutment(1) < girder(2) <
    deck(3) < parapet(4)} shaping the CE class weights
    (bridge_structure_weights);
  - sol_loss: the structure-oriented loss (existence and pairwise z-order
    violation penalties on the CE weights);
  - dice_loss, combined_ce_dice_loss;
  - feature_transform_regularizer: ||I - A A^T|| on TNet outputs.

All losses take logits [B, N, C]. The weight-shaping terms are computed from
argmax predictions under ``torch.no_grad()``, where the JAX package uses
``stop_gradient``: the gradient reaches the logits only through the CE.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _flat_logp_target(logits, labels, label_smoothing):
    c = logits.shape[-1]
    logp = F.log_softmax(logits.reshape(-1, c).float(), dim=-1)
    labels = labels.reshape(-1).long()
    onehot = F.one_hot(labels, c).float()
    if label_smoothing > 0.0:
        onehot = onehot * (1.0 - label_smoothing) + label_smoothing / c
    return logp, labels, onehot


def weighted_cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    class_weights: Optional[torch.Tensor] = None,
    label_smoothing: float = 0.0,
) -> torch.Tensor:
    """Mean weighted cross entropy over all points (losses.py:35-63).

    logits [..., C]; labels integer [...]; class_weights [C] or None. The
    class weight applies inside the smoothed target sum (-sum_c q_c w_c
    logp_c), and the mean is normalised by the summed true-class weights.
    """
    numer, denom = weighted_cross_entropy_sums(
        logits, labels, class_weights, label_smoothing
    )
    if class_weights is None:
        return numer / denom
    return numer / torch.clamp(denom, min=1e-8)


def weighted_cross_entropy_sums(
    logits: torch.Tensor,
    labels: torch.Tensor,
    class_weights: Optional[torch.Tensor] = None,
    label_smoothing: float = 0.0,
) -> tuple:
    """Decomposed weighted CE -> (weighted NLL sum, weight sum), so that
    ``weighted_cross_entropy == numer / denom`` (losses.py:66-91)."""
    logp, labels, onehot = _flat_logp_target(logits, labels, label_smoothing)
    if class_weights is None:
        nll = -(onehot * logp).sum(-1)
        return nll.sum(), torch.full((), float(labels.shape[0]), device=logp.device)
    w = class_weights.to(device=logp.device, dtype=torch.float32)
    nll = -(onehot * w[None, :] * logp).sum(-1)
    return nll.sum(), w[labels].sum()


def class_weights_from_counts(
    counts, clip_min: float = 0.5, clip_max: float = 3.0
) -> torch.Tensor:
    """Inverse-frequency class weights total / (counts * C), clamped to
    [clip_min, clip_max]. counts: [C] label histogram."""
    counts = torch.as_tensor(counts, dtype=torch.float32) + 1e-6
    weights = counts.sum() / (counts * counts.shape[0])
    return torch.clamp(weights, clip_min, clip_max)


def _masked_norm_z_mean(xyz: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean normalised z of the masked points of each batch element:
    xyz [B, N, 3], mask [B, N] bool -> [B]; 0 where nothing is masked."""
    z = xyz[..., 2]
    big = torch.full((), 1e9, dtype=z.dtype, device=z.device)
    zmin = torch.where(mask, z, big).amin(1)
    zmax = torch.where(mask, z, -big).amax(1)
    rng = torch.clamp(zmax - zmin, min=1e-7)
    zn = (z - zmin[:, None]) / rng[:, None]
    cnt = mask.sum(1)
    mean = torch.where(mask, zn, 0.0).sum(1) / torch.clamp(cnt, min=1)
    return torch.where(cnt > 0, mean, 0.0)


# the per-class base weights of bridge_structure_loss (losses.py:127-182)
BSL_BASE_WEIGHTS = (1.5, 1.0, 1.2, 1.5, 1.0)

# hierarchy: class -> the classes that must lie below it
_BSL_ABOVE = {1: (), 2: (1,), 3: (1, 2), 4: (1, 2, 3)}


def bridge_structure_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    xyz: torch.Tensor,
    alpha: float = 20.0,
    rel_margin: float = 0.2,
    base_weights: Optional[torch.Tensor] = None,
    num_classes: int = 5,
) -> torch.Tensor:
    """Hierarchy-prior weighted CE (losses.py:127-182): the CE with label
    smoothing 0.2 under the class weights that ``bridge_structure_weights``
    gives for the logits' argmax predictions."""
    with torch.no_grad():
        final_w = bridge_structure_weights(logits.argmax(-1), labels, xyz, alpha, rel_margin,
                                           base_weights, num_classes)
    return weighted_cross_entropy(logits, labels.long(), final_w, label_smoothing=0.2)


def bridge_structure_weights(
    preds: torch.Tensor,
    labels: torch.Tensor,
    xyz: torch.Tensor,
    alpha: float = 20.0,
    rel_margin: float = 0.2,
    base_weights: Optional[torch.Tensor] = None,
    num_classes: int = 5,
) -> torch.Tensor:
    """The per-class weights of ``bridge_structure_loss`` for the predicted
    classes preds [B, N] -> [num_classes].

    For each ordered pair (upper, lower) of the bridge hierarchy, a ReLU
    margin violation of the predicted z-centroids adds alpha-scaled weight
    to both classes; class 0 gets alpha * (1 - predicted-other fraction).
    The per-class weight is the batch mean times inverse-sqrt label
    frequencies with classes 1 and 4 doubled. A step function of the
    predictions: one point whose argmax changes moves the weights.
    """
    labels = labels.long()
    b = labels.shape[0]
    dev = preds.device
    if base_weights is None:  # made on the device: no copy from the host
        base_weights = torch.empty(len(BSL_BASE_WEIGHTS), dtype=torch.float32, device=dev)
        for c, w in enumerate(BSL_BASE_WEIGHTS):
            base_weights[c].fill_(w)
    xyz = xyz.float()
    weights = base_weights.to(dev, torch.float32)[None, :].repeat(b, 1)
    exists = {c: (labels == c).any(1) for c in (1, 2, 3, 4)}
    rel = {c: _masked_norm_z_mean(xyz, preds == c) for c in (1, 2, 3, 4)}
    for cid in (1, 2, 3, 4):
        for lower in _BSL_ABOVE[cid]:
            gate = (exists[cid] & exists[lower]).float()
            violation = F.relu(-(rel[cid] - rel[lower]) + rel_margin) * gate
            weights[:, cid] += alpha * violation
            weights[:, lower] += alpha * violation * 0.5
            weights[:, lower] += alpha * violation
            weights[:, cid] += alpha * violation * 0.3
    other_frac = (preds == 0).float().mean(1)
    weights[:, 0] += alpha * (1.0 - other_frac)
    # a label >= num_classes goes to the last bin, which is dropped; fixed
    # length, so that a CUDA graph can capture it (bincount sizes its output
    # on the host)
    flat = labels.reshape(-1)
    counts = torch.zeros(num_classes + 1, dtype=torch.int64, device=dev)
    counts = counts.scatter_add_(0, flat.clamp(max=num_classes), torch.ones_like(flat))
    counts = counts[:num_classes]
    freq_w = 1.0 / torch.sqrt(torch.clamp(counts.float(), min=1.0))
    freq_w[1] *= 2.0
    freq_w[4] *= 2.0
    return weights.mean(0) * freq_w


def sol_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    xyz: torch.Tensor,
    a: float = 200.0,
    num_classes: int = 5,
) -> torch.Tensor:
    """Structure-oriented loss (losses.py:185-241): per batch element,
    weights start at 1; +a for a class predicted but absent in the labels;
    +k*a (k = hierarchy distance 1/2/3) to both classes of each pair whose
    label z-order is violated by the prediction. Each element's weighted CE
    over the whole batch is summed."""
    with torch.no_grad():
        labels = labels.long()
        b = labels.shape[0]
        preds = logits.argmax(-1)
        z = xyz[..., 2].float()

        def centers(lbl):
            cs, ex = [], []
            for c in range(4):
                m = lbl == c
                cnt = m.sum(1)
                cs.append(torch.where(m, z, 0.0).sum(1) / torch.clamp(cnt, min=1))
                ex.append(cnt > 0)
            return torch.stack(cs, -1), torch.stack(ex, -1)

        gt_c, gt_e = centers(labels)
        pr_c, pr_e = centers(preds)
        weights = torch.ones((b, num_classes), dtype=torch.float32, device=logits.device)
        for c in range(4):
            weights[:, c] += a * ((~gt_e[:, c]) & pr_e[:, c]).float()
        for lo, hi, lvl in ((0, 1, 1), (1, 2, 1), (2, 3, 1), (0, 2, 2), (1, 3, 2), (0, 3, 3)):
            both = gt_e[:, lo] & pr_e[:, lo] & gt_e[:, hi] & pr_e[:, hi]
            violated = (gt_c[:, lo] < gt_c[:, hi]) & (pr_c[:, lo] >= pr_c[:, hi])
            add = (both & violated).float() * (lvl * a)
            weights[:, lo] += add
            weights[:, hi] += add
    total = None
    for i in range(b):
        ce = weighted_cross_entropy(logits, labels, weights[i])
        total = ce if total is None else total + ce
    return total


def dice_loss(logits: torch.Tensor, labels: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Soft multi-class Dice loss 1 - mean_c (2|p∩t| + eps) / (|p| + |t| + eps)."""
    c = logits.shape[-1]
    probs = F.softmax(logits.reshape(-1, c), dim=-1)
    onehot = F.one_hot(labels.reshape(-1).long(), c).to(probs.dtype)
    inter = (probs * onehot).sum(0)
    denom = probs.sum(0) + onehot.sum(0)
    dice = (2.0 * inter + eps) / (denom + eps)
    return 1.0 - dice.mean()


def combined_ce_dice_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    class_weights: Optional[torch.Tensor] = None,
    alpha: float = 0.8,
) -> torch.Tensor:
    """alpha * CE + (1 - alpha) * Dice."""
    ce = weighted_cross_entropy(logits, labels, class_weights)
    return alpha * ce + (1.0 - alpha) * dice_loss(logits, labels)


def feature_transform_regularizer(trans: torch.Tensor) -> torch.Tensor:
    """||I - A A^T||_F, mean over the batch. trans [B, D, D]."""
    d = trans.shape[-1]
    eye = torch.eye(d, dtype=trans.dtype, device=trans.device)
    diff = eye[None] - torch.einsum("bij,bkj->bik", trans, trans)
    return torch.linalg.matrix_norm(diff).mean()
