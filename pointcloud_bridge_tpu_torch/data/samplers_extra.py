"""Remaining block-sampler variants from SURVEY.md §2.4:

  - simple_random_blocks: SimplePointCloudDataset (utils/simpdataset.py) —
    steps_per_file random whole-file subsamples, NaN scrubbing, placeholder
    items on failure.
  - chunked_blocks: data_utils_ver2 BridgePointCloudDataset — sequential
    index chunking (chunk_size=8192, overlap=1024 by default; config.yaml
    carries chunk_size/overlap) then FPS downsample to num_points per chunk;
    validation_chunk_subset gives the seeded 30% subset
    (data_utils_ver2.py:182-212).
  - overlapping_grid_blocks: data_utils BridgePointCloudDataset — overlapping
    xy grid (overlap ratio 0.3), center-subtracted (data_utils.py:16-122).
  - hv_grid_blocks: BridgePCDataset — 3D sliding blocks with separate
    horizontal/vertical sizes & strides + min_points filter
    (utils/BridgePCDataset.py:8-268).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .blocks import Block, normalize_points


def _numpy_fps(xyz: np.ndarray, npoint: int, start: int = 0) -> np.ndarray:
    """Host-side FPS identical to the device op (pointnet2_utils.py:63-80)."""
    n = len(xyz)
    out = np.zeros(npoint, np.int64)
    dist = np.full(n, 1e10)
    far = start
    for i in range(npoint):
        out[i] = far
        d = ((xyz - xyz[far]) ** 2).sum(axis=1)
        np.minimum(dist, d, out=dist)
        far = int(dist.argmax())
    return out


def simple_random_blocks(
    points: np.ndarray,
    colors: np.ndarray,
    labels: np.ndarray,
    num_points: int = 4096,
    steps_per_file: int = 10,
    file_name: str = "",
    seed: int = 0,
) -> List[Block]:
    """steps_per_file random subsamples of the whole (normalized) scene;
    scenes smaller than num_points are padded with replacement
    (simpdataset.py:103-153)."""
    rng = np.random.default_rng(seed)
    # NaN scrubbing (simpdataset.py:169-190)
    finite = np.isfinite(points).all(axis=1)
    points, colors, labels = points[finite], colors[finite], labels[finite]
    n = len(points)
    if n == 0:  # placeholder item (simpdataset.py:201-212)
        z = np.zeros((num_points, 3), np.float32)
        return [
            Block(z, z.copy(), np.zeros(num_points, np.int64), z.copy(),
                  np.zeros(num_points, np.int64), file_name)
        ]
    normal = normalize_points(points.astype(np.float64)).astype(np.float32)
    blocks = []
    for _ in range(steps_per_file):
        if n >= num_points:
            sel = rng.choice(n, num_points, replace=False)
        else:
            sel = np.concatenate(
                [np.arange(n), rng.choice(n, num_points - n, replace=True)]
            )
            rng.shuffle(sel)
        blocks.append(
            Block(
                points=normal[sel],
                colors=colors[sel].astype(np.float32),
                labels=labels[sel].astype(np.int64),
                original_points=points[sel].astype(np.float32),
                indices=sel.astype(np.int64),
                file_name=file_name,
            )
        )
    return blocks


def chunked_blocks(
    points: np.ndarray,
    colors: np.ndarray,
    labels: np.ndarray,
    num_points: int = 4096,
    chunk_size: int = 8192,
    overlap: int = 1024,
    file_name: str = "",
) -> List[Block]:
    """Sequential point-index chunking + FPS downsample per chunk
    (data_utils_ver2.py:70-93)."""
    n = len(points)
    normal = normalize_points(points.astype(np.float64)).astype(np.float32)
    num_chunks = max(1, (n - overlap) // (chunk_size - overlap))
    blocks = []
    for ci in range(num_chunks):
        s = ci * (chunk_size - overlap)
        e = min(s + chunk_size, n)
        idx = np.arange(s, e)
        if len(idx) > num_points:
            sel_local = _numpy_fps(normal[idx], num_points)
            idx = idx[sel_local]
        elif len(idx) < num_points:
            pad = np.random.default_rng(ci).choice(
                idx, num_points - len(idx), replace=True
            )
            idx = np.concatenate([idx, pad])
        blocks.append(
            Block(
                points=normal[idx],
                colors=colors[idx].astype(np.float32),
                labels=labels[idx].astype(np.int64),
                original_points=points[idx].astype(np.float32),
                indices=idx.astype(np.int64),
                file_name=file_name,
            )
        )
    return blocks


def validation_chunk_subset(
    blocks: List[Block], fraction: float = 0.3, seed: int = 42
) -> List[Block]:
    """Seeded random subset of chunks (BridgeValidationDataset,
    data_utils_ver2.py:182-212)."""
    rng = np.random.default_rng(seed)
    k = max(1, int(len(blocks) * fraction))
    sel = rng.choice(len(blocks), k, replace=False)
    return [blocks[i] for i in sorted(sel)]


def overlapping_grid_blocks(
    points: np.ndarray,
    colors: np.ndarray,
    labels: np.ndarray,
    num_points: int = 4096,
    block_size: float = 2.0,
    overlap: float = 0.3,
    min_points: int = 100,
    file_name: str = "",
    seed: int = 0,
) -> List[Block]:
    """Overlapping xy grid with center-subtracted coordinates
    (data_utils.py:16-122)."""
    rng = np.random.default_rng(seed)
    stride = block_size * (1.0 - overlap)
    mins = points[:, :2].min(axis=0)
    maxs = points[:, :2].max(axis=0)
    blocks = []
    y = mins[1]
    while y < maxs[1] + 1e-9:
        x = mins[0]
        while x < maxs[0] + 1e-9:
            mask = (
                (points[:, 0] >= x)
                & (points[:, 0] < x + block_size)
                & (points[:, 1] >= y)
                & (points[:, 1] < y + block_size)
            )
            idx = np.where(mask)[0]
            if len(idx) >= min_points:
                sel = rng.choice(idx, num_points, replace=len(idx) < num_points)
                center = np.array(
                    [x + block_size / 2, y + block_size / 2, 0.0], np.float32
                )
                blk_pts = points[sel].astype(np.float32) - center
                blocks.append(
                    Block(
                        points=blk_pts,
                        colors=colors[sel].astype(np.float32),
                        labels=labels[sel].astype(np.int64),
                        original_points=points[sel].astype(np.float32),
                        indices=sel.astype(np.int64),
                        file_name=file_name,
                    )
                )
            x += stride
        y += stride
    return blocks


def hv_grid_blocks(
    points: np.ndarray,
    colors: np.ndarray,
    labels: np.ndarray,
    num_points: int = 4096,
    h_block_size: float = 2.0,
    v_block_size: float = 2.0,
    h_stride: float = 1.0,
    v_stride: float = 1.0,
    min_points: int = 100,
    file_name: str = "",
    seed: int = 0,
) -> List[Block]:
    """3D sliding blocks with separate horizontal/vertical block sizes and
    strides (BridgePCDataset.py:8-268)."""
    rng = np.random.default_rng(seed)
    mins = points.min(axis=0)
    maxs = points.max(axis=0)
    blocks = []
    z = mins[2]
    while z < maxs[2] + 1e-9:
        y = mins[1]
        while y < maxs[1] + 1e-9:
            x = mins[0]
            while x < maxs[0] + 1e-9:
                mask = (
                    (points[:, 0] >= x)
                    & (points[:, 0] < x + h_block_size)
                    & (points[:, 1] >= y)
                    & (points[:, 1] < y + h_block_size)
                    & (points[:, 2] >= z)
                    & (points[:, 2] < z + v_block_size)
                )
                idx = np.where(mask)[0]
                if len(idx) >= min_points:
                    sel = rng.choice(
                        idx, num_points, replace=len(idx) < num_points
                    )
                    center = np.array(
                        [x + h_block_size / 2, y + h_block_size / 2,
                         z + v_block_size / 2], np.float32,
                    )
                    blocks.append(
                        Block(
                            points=points[sel].astype(np.float32) - center,
                            colors=colors[sel].astype(np.float32),
                            labels=labels[sel].astype(np.int64),
                            original_points=points[sel].astype(np.float32),
                            indices=sel.astype(np.int64),
                            file_name=file_name,
                        )
                    )
                x += h_stride
            y += v_stride
        z += v_stride
    return blocks
