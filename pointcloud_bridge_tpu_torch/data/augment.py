"""Point-cloud augmentations.

  - apply_transform: the BriPCDMulti per-block augmentation — random z
    rotation, translation U(0.01, 0.1), scale U(0.9, 1.1), color jitter
    N(0, 0.02) clipped (BriPCDMulti.py:367-403).
  - provider-style batch augmentations operating on [B, N, C]
    (Partsize-identical/provider.py): z/3d rotation, jitter, shift, scale,
    random point dropout.

All functions are host-side numpy with explicit Generators (the reference
uses the global unseeded numpy RNG; we require seeds — SURVEY.md §7 hard
part #5, parity is distributional).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _rotz(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float64)


def apply_transform(
    points: np.ndarray,
    colors: Optional[np.ndarray],
    rng: np.random.Generator,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """BriPCDMulti.apply_transform (BriPCDMulti.py:367-403)."""
    points = points.copy()
    theta = rng.uniform(0, 2 * np.pi)
    points = points @ _rotz(theta)
    points = points + rng.uniform(0.01, 0.1, size=(1, 3))
    points = points * rng.uniform(0.9, 1.1)
    if colors is not None:
        colors = np.clip(colors + rng.normal(0, 0.02, colors.shape), 0, 1)
    return points.astype(np.float32), (
        None if colors is None else colors.astype(np.float32)
    )


# --- provider.py-style batch augmentations ([B, N, C]) ---


def rotate_point_cloud_z(batch: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    out = batch.copy()
    for b in range(len(batch)):
        out[b, :, :3] = batch[b, :, :3] @ _rotz(rng.uniform(0, 2 * np.pi))
    return out


def jitter_point_cloud(
    batch: np.ndarray, rng: np.random.Generator, sigma: float = 0.01, clip: float = 0.05
) -> np.ndarray:
    noise = np.clip(sigma * rng.standard_normal(batch[..., :3].shape), -clip, clip)
    out = batch.copy()
    out[..., :3] += noise
    return out


def shift_point_cloud(
    batch: np.ndarray, rng: np.random.Generator, shift_range: float = 0.1
) -> np.ndarray:
    shifts = rng.uniform(-shift_range, shift_range, (len(batch), 1, 3))
    out = batch.copy()
    out[..., :3] += shifts
    return out


def random_scale_point_cloud(
    batch: np.ndarray,
    rng: np.random.Generator,
    scale_low: float = 0.8,
    scale_high: float = 1.25,
) -> np.ndarray:
    scales = rng.uniform(scale_low, scale_high, (len(batch), 1, 1))
    out = batch.copy()
    out[..., :3] *= scales
    return out


def random_point_dropout(
    batch: np.ndarray, rng: np.random.Generator, max_dropout_ratio: float = 0.875
) -> np.ndarray:
    """Replace a random subset of each cloud with its first point
    (provider.py random_point_dropout semantics)."""
    out = batch.copy()
    for b in range(len(batch)):
        ratio = rng.uniform() * max_dropout_ratio
        drop = np.where(rng.uniform(size=batch.shape[1]) <= ratio)[0]
        if len(drop) > 0:
            out[b, drop] = out[b, 0]
    return out


# --- remaining provider.py functions (VERDICT r3 missing #1) ---
# The reference's up axis in these is Y (rotation about y), unlike the
# z-rotation its bridge trainers actually call; ported for completeness.


def _roty(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)


def normalize_data(batch: np.ndarray) -> np.ndarray:
    """Center each cloud at its centroid and scale to the unit sphere
    (provider.py:3-19)."""
    out = batch.astype(np.float64).copy()
    centroid = np.mean(out, axis=1, keepdims=True)
    out -= centroid
    m = np.max(np.linalg.norm(out, axis=-1), axis=1)  # [B]
    return (out / m[:, None, None]).astype(batch.dtype)


def shuffle_data(
    data: np.ndarray, labels: np.ndarray, rng: np.random.Generator
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Shuffle the batch axis; returns (data, labels, idx)
    (provider.py:21-31)."""
    idx = rng.permutation(len(labels))
    return data[idx, ...], labels[idx], idx


def shuffle_points(batch: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Shuffle point order with ONE permutation shared across the batch —
    changes FPS behavior (provider.py:33-43)."""
    idx = rng.permutation(batch.shape[1])
    return batch[:, idx, :]


def rotate_point_cloud(batch: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Per-cloud random rotation about the Y (up) axis (provider.py:45-63)."""
    out = batch.copy()
    for b in range(len(batch)):
        out[b, :, :3] = batch[b, :, :3] @ _roty(rng.uniform(0, 2 * np.pi))
    return out


def rotate_point_cloud_with_normal(
    batch: np.ndarray, rng: np.random.Generator
) -> np.ndarray:
    """Y-rotation applied to xyz (cols 0:3) AND normals (cols 3:6)
    (provider.py:86-104)."""
    out = batch.copy()
    for b in range(len(batch)):
        r = _roty(rng.uniform(0, 2 * np.pi))
        out[b, :, 0:3] = batch[b, :, 0:3] @ r
        out[b, :, 3:6] = batch[b, :, 3:6] @ r
    return out


def _perturbation_rotation(rng, angle_sigma: float, angle_clip: float):
    a = np.clip(angle_sigma * rng.standard_normal(3), -angle_clip, angle_clip)
    rx = np.array([[1, 0, 0],
                   [0, np.cos(a[0]), -np.sin(a[0])],
                   [0, np.sin(a[0]), np.cos(a[0])]])
    ry = np.array([[np.cos(a[1]), 0, np.sin(a[1])],
                   [0, 1, 0],
                   [-np.sin(a[1]), 0, np.cos(a[1])]])
    rz = np.array([[np.cos(a[2]), -np.sin(a[2]), 0],
                   [np.sin(a[2]), np.cos(a[2]), 0],
                   [0, 0, 1]])
    return rz @ ry @ rx


def rotate_perturbation_point_cloud(
    batch: np.ndarray,
    rng: np.random.Generator,
    angle_sigma: float = 0.06,
    angle_clip: float = 0.18,
) -> np.ndarray:
    """Small random 3-axis rotation per cloud (provider.py:176-199)."""
    out = batch.copy()
    for b in range(len(batch)):
        out[b, :, :3] = batch[b, :, :3] @ _perturbation_rotation(
            rng, angle_sigma, angle_clip
        )
    return out


def rotate_perturbation_point_cloud_with_normal(
    batch: np.ndarray,
    rng: np.random.Generator,
    angle_sigma: float = 0.06,
    angle_clip: float = 0.18,
) -> np.ndarray:
    """Perturbation rotation applied to xyz and normals (provider.py:106-131)."""
    out = batch.copy()
    for b in range(len(batch)):
        r = _perturbation_rotation(rng, angle_sigma, angle_clip)
        out[b, :, 0:3] = batch[b, :, 0:3] @ r
        out[b, :, 3:6] = batch[b, :, 3:6] @ r
    return out


def rotate_point_cloud_by_angle(
    batch: np.ndarray, rotation_angle: float
) -> np.ndarray:
    """Deterministic Y-rotation by a given angle (provider.py:133-150)."""
    out = batch.copy()
    r = _roty(rotation_angle)
    out[..., :3] = batch[..., :3] @ r
    return out


def rotate_point_cloud_by_angle_with_normal(
    batch: np.ndarray, rotation_angle: float
) -> np.ndarray:
    """Deterministic Y-rotation of xyz and normals (provider.py:152-173)."""
    out = batch.copy()
    r = _roty(rotation_angle)
    out[..., 0:3] = batch[..., 0:3] @ r
    out[..., 3:6] = batch[..., 3:6] @ r
    return out
