"""AVS-Net: PI-controlled adaptive voxel sampling
(Highway_bridge/models/pointnet2_utils.py:363-485), a host copy of
pointcloud_bridge_tpu/ops/avs.py, equal statement for statement.

The reference defines this as an alternative sampler module that its forward
paths never call (dead code); it voxel-downsamples with a voxel size tuned by
a PI controller toward a target point count, then recovers indices of the
nearest ORIGINAL points to the voxel centroids. Unique-voxel counting gives
shapes that depend on the data, so it runs on the host in numpy, a sampler
of the data layer. Semantics are transcribed exactly, including the
reference's integer voxel key (x*1e6 + y*1e3 + z, collisions and all),
zero-padding of ragged batches, and the pad/random-trim of the final index
set.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _sigmoid(x: float) -> float:
    return 1.0 / (1.0 + np.exp(-x))


def avs_voxel_downsample(xyz: np.ndarray, voxel_size: float) -> np.ndarray:
    """Per-batch voxel-centroid downsampling, zero-padded to the max voxel
    count (pointnet2_utils.py:373-414). xyz [B, N, 3] -> [B, M, 3]."""
    b, n, c = xyz.shape
    results = []
    for bi in range(b):
        coords = np.floor(xyz[bi] / voxel_size).astype(np.int64)
        keys = coords[:, 0] * 1_000_000 + coords[:, 1] * 1_000 + coords[:, 2]
        uniq, inverse = np.unique(keys, return_inverse=True)
        centroids = np.zeros((len(uniq), c), dtype=xyz.dtype)
        count = np.zeros(len(uniq), dtype=xyz.dtype)
        np.add.at(centroids, inverse, xyz[bi])
        np.add.at(count, inverse, 1.0)
        centroids = centroids / np.maximum(count, 1.0)[:, None]
        results.append(centroids)
    max_len = max(len(r) for r in results)
    padded = [
        np.concatenate(
            [r, np.zeros((max_len - len(r), c), dtype=xyz.dtype)], axis=0
        )
        if len(r) < max_len
        else r
        for r in results
    ]
    return np.stack(padded)


def avs_adapt_voxel_size(
    xyz: np.ndarray,
    npoint: int,
    v0: float = 0.02,
    kp: float = 0.5,
    ki: float = 0.1,
    max_iter: int = 10,
) -> float:
    """PI-controller loop sizing the voxel toward N/npoint reduction
    (pointnet2_utils.py:416-445)."""
    n = xyz.shape[1]
    target_ratio = n / npoint
    scale, sum_err = 0.0, 0.0
    voxel_size = v0
    for _ in range(max_iter):
        voxel_size = v0 * float(np.exp(scale))
        sampled = avs_voxel_downsample(xyz, voxel_size)
        current_ratio = n / sampled.shape[1]
        err = target_ratio - current_ratio
        sum_err += err
        diff = kp * err + ki * sum_err
        scale += 0.01 * (_sigmoid(diff) - 0.5)
        if abs(sampled.shape[1] - npoint) <= npoint * 0.1:
            break
    return voxel_size


def avs_net_sample_indices(
    xyz: np.ndarray,
    npoint: int,
    v0: float = 0.02,
    kp: float = 0.5,
    ki: float = 0.1,
    max_iter: int = 10,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, float]:
    """AVSNet.forward (pointnet2_utils.py:448-485): adapt voxel size, voxel
    downsample, recover the nearest original index per voxel centroid, then
    randomly trim (or last-index pad) to exactly npoint.

    Returns (indices [B, npoint] int64, voxel_size).
    """
    if rng is None:
        rng = np.random.default_rng()
    b = xyz.shape[0]
    voxel_size = avs_adapt_voxel_size(xyz, npoint, v0, kp, ki, max_iter)
    sampled = avs_voxel_downsample(xyz, voxel_size)
    out = []
    for bi in range(b):
        # nearest ORIGINAL point per sampled centroid (argmin over N)
        dist = np.sum(
            (xyz[bi][:, None, :] - sampled[bi][None, :, :]) ** 2, axis=2
        )
        idx = np.argmin(dist, axis=0)
        if len(idx) > npoint:
            idx = idx[rng.permutation(len(idx))[:npoint]]
        elif len(idx) < npoint:
            idx = np.concatenate(
                [idx, np.full(npoint - len(idx), idx[-1], dtype=idx.dtype)]
            )
        out.append(idx)
    return np.stack(out), voxel_size
