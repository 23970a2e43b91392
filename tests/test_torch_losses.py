"""The PyTorch port's losses, lr schedules and masked confusion matrix
against the JAX package's, on the CPU, with seeded numpy inputs.

Each loss is compared in value and in its gradient to the logits: the
weight-shaping terms are computed under ``torch.no_grad()`` where the JAX
package uses ``stop_gradient``, so the gradients agree only if that holds.
Values and gradients agree within 1e-5 relative (float32 reductions in
another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_bridge_tpu import losses as JL
from pointcloud_bridge_tpu.train import schedules as JS
from pointcloud_bridge_tpu.utils import metrics as JM
from pointcloud_bridge_tpu_torch import losses as L
from pointcloud_bridge_tpu_torch.train import schedules as S
from pointcloud_bridge_tpu_torch.utils import metrics as M


def _inputs(seed, b=3, n=200, c=5):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(b, n, c)).astype(np.float32) * 2
    xyz = rng.uniform(size=(b, n, 3)).astype(np.float32)
    # labels follow height bands, so the structure losses see hierarchies
    # both kept and violated by the (random) predictions
    labels = np.clip((xyz[..., 2] * c).astype(np.int32), 0, c - 1)
    labels[0, :20] = rng.integers(0, c, 20)
    return logits, labels, xyz


def _both(jax_fn, torch_fn, logits, *rest):
    """(value, dvalue/dlogits) of both implementations."""
    jv, jg = jax.value_and_grad(lambda lg: jax_fn(lg, *[jnp.asarray(r) for r in rest]))(
        jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_(True)
    tv = torch_fn(t, *[torch.from_numpy(np.asarray(r)) for r in rest])
    tv.backward()
    return (float(jv), np.asarray(jg)), (float(tv.detach()), t.grad.numpy())


def _assert_same(want, got):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5 * np.abs(want[1]).max())


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("weighted", [False, True])
def test_weighted_cross_entropy_matches_jax(smoothing, weighted):
    logits, labels, _ = _inputs(0)
    w = np.array([0.5, 1.0, 2.0, 3.0, 0.7], np.float32)
    cw = (w,) if weighted else ()
    want, got = _both(
        lambda lg, lb, *c: JL.weighted_cross_entropy(lg, lb, c[0] if c else None, smoothing),
        lambda lg, lb, *c: L.weighted_cross_entropy(lg, lb, c[0] if c else None, smoothing),
        logits, labels, *cw,
    )
    _assert_same(want, got)
    # the decomposed sums give the same mean
    jn, jd = JL.weighted_cross_entropy_sums(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(w) if weighted else None, smoothing)
    tn, td = L.weighted_cross_entropy_sums(
        torch.from_numpy(logits), torch.from_numpy(labels),
        torch.from_numpy(w) if weighted else None, smoothing)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-5)
    np.testing.assert_allclose(float(td), float(jd), rtol=1e-6)


def test_class_weights_from_counts_matches_jax():
    counts = np.array([50000, 1200, 300, 0, 8000], np.float64)
    want = np.asarray(JL.class_weights_from_counts(jnp.asarray(counts)))
    got = L.class_weights_from_counts(counts).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got.min() >= 0.5 and got.max() <= 3.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bridge_structure_loss_matches_jax(seed):
    logits, labels, xyz = _inputs(seed)
    want, got = _both(
        lambda lg, lb, x: JL.bridge_structure_loss(lg, lb, x, alpha=80.0, rel_margin=0.3),
        lambda lg, lb, x: L.bridge_structure_loss(lg, lb, x, alpha=80.0, rel_margin=0.3),
        logits, labels, xyz,
    )
    _assert_same(want, got)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sol_loss_matches_jax(seed):
    logits, labels, xyz = _inputs(seed)
    want, got = _both(JL.sol_loss, L.sol_loss, logits, labels, xyz)
    _assert_same(want, got)


def test_dice_and_combined_losses_match_jax():
    logits, labels, _ = _inputs(3)
    _assert_same(*_both(JL.dice_loss, L.dice_loss, logits, labels))
    w = np.array([0.5, 1.0, 2.0, 3.0, 0.7], np.float32)
    _assert_same(*_both(JL.combined_ce_dice_loss, L.combined_ce_dice_loss, logits, labels, w))


def test_feature_transform_regularizer_matches_jax(rng):
    trans = rng.normal(size=(4, 16, 16)).astype(np.float32)
    jv, jg = jax.value_and_grad(JL.feature_transform_regularizer)(jnp.asarray(trans))
    t = torch.from_numpy(trans).requires_grad_(True)
    tv = L.feature_transform_regularizer(t)
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-6)


def test_schedules_match_jax():
    for epoch in range(0, 40, 3):
        assert S.cosine_lr(1e-3, epoch, 30) == JS.cosine_lr(1e-3, epoch, 30)
        assert S.cosine_lr(1e-3, epoch, 30, 1e-5) == JS.cosine_lr(1e-3, epoch, 30, 1e-5)
        assert S.step_decay_lr(1e-3, epoch) == JS.step_decay_lr(1e-3, epoch)
    ours = S.ReduceLROnPlateau(lr=1e-3, patience=2)
    ref = JS.ReduceLROnPlateau(lr=1e-3, patience=2)
    accs = [0.5, 0.6, 0.6, 0.55, 0.58, 0.61, 0.61, 0.6, 0.6, 0.59, 0.6, 0.6]
    got = [ours.step(a) for a in accs]
    assert got == [ref.step(a) for a in accs]
    assert min(got) < 1e-3  # it did reduce


def test_masked_confusion_matrix_matches_jax(rng):
    preds = rng.integers(0, 5, size=(4, 64)).astype(np.int32)
    labels = rng.integers(0, 5, size=(4, 64)).astype(np.int32)
    mask = np.broadcast_to(np.array([True, True, False, True])[:, None], labels.shape)
    want = np.asarray(JM.masked_confusion_matrix(
        jnp.asarray(preds), jnp.asarray(labels), jnp.asarray(mask), 5))
    got = M.masked_confusion_matrix(
        torch.from_numpy(preds), torch.from_numpy(labels), torch.from_numpy(mask.copy()), 5)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.sum() == 3 * 64
