"""Synthetic point-cloud fixtures (the reference's only 'fake backend':
RandomPointCloudDataset, Highway_bridge/models/model.py:487-503).

Also provides a structured 'toy bridge' generator whose classes follow the
reference 5-class layout {noise:0, abutment:1, girder:2, deck:3, parapet:4}
with the correct z-hierarchy, so segmentation models can actually learn it in
smoke/overfit tests.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def random_blocks(
    num_blocks: int,
    num_points: int = 4096,
    num_classes: int = 5,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pure-noise blocks: points ~ N(0,1), colors ~ U(0,1), labels uniform."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(num_blocks, num_points, 3)).astype(np.float32)
    cols = rng.uniform(size=(num_blocks, num_points, 3)).astype(np.float32)
    labels = rng.integers(0, num_classes, size=(num_blocks, num_points)).astype(
        np.int32
    )
    return pts, cols, labels


def toy_bridge_scene(
    num_points: int = 20000, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A synthetic bridge-like scene in the reference's 5-class layout.

    Geometry (z up): two abutment blocks (class 1) at the ends near z∈[0,2],
    girders (2) spanning at z∈[2,2.6], deck slab (3) at z∈[2.6,2.9], parapets
    (4) as thin walls at the deck edges z∈[2.9,3.9], plus scattered noise (0).
    Colors loosely correlate with class so color-aware models get signal.
    Returns (xyz [N,3] float32, rgb [N,3] float32 in [0,1], labels [N] int32).
    """
    rng = np.random.default_rng(seed)
    n = num_points
    frac = {0: 0.05, 1: 0.15, 2: 0.25, 3: 0.40, 4: 0.15}
    counts = {c: int(n * f) for c, f in frac.items()}
    counts[3] += n - sum(counts.values())

    parts = []
    length, width = 20.0, 6.0

    # abutments: x in [0,2] and [18,20]
    na = counts[1]
    xa = np.concatenate(
        [rng.uniform(0, 2, na // 2), rng.uniform(length - 2, length, na - na // 2)]
    )
    parts.append(
        (
            np.stack(
                [xa, rng.uniform(0, width, na), rng.uniform(0, 2.0, na)], axis=1
            ),
            np.full(na, 1),
        )
    )
    # girders: 3 lines along x
    ng = counts[2]
    ys = rng.choice([1.0, 3.0, 5.0], ng) + rng.normal(0, 0.1, ng)
    parts.append(
        (
            np.stack(
                [rng.uniform(0, length, ng), ys, rng.uniform(2.0, 2.6, ng)], axis=1
            ),
            np.full(ng, 2),
        )
    )
    # deck
    nd = counts[3]
    parts.append(
        (
            np.stack(
                [
                    rng.uniform(0, length, nd),
                    rng.uniform(0, width, nd),
                    rng.uniform(2.6, 2.9, nd),
                ],
                axis=1,
            ),
            np.full(nd, 3),
        )
    )
    # parapets: walls at y ~ 0 and y ~ width
    np_ = counts[4]
    yp = np.concatenate(
        [
            rng.normal(0.1, 0.05, np_ // 2),
            rng.normal(width - 0.1, 0.05, np_ - np_ // 2),
        ]
    )
    parts.append(
        (
            np.stack(
                [rng.uniform(0, length, np_), yp, rng.uniform(2.9, 3.9, np_)],
                axis=1,
            ),
            np.full(np_, 4),
        )
    )
    # noise everywhere
    nn_ = counts[0]
    parts.append(
        (
            np.stack(
                [
                    rng.uniform(-2, length + 2, nn_),
                    rng.uniform(-2, width + 2, nn_),
                    rng.uniform(-1, 5, nn_),
                ],
                axis=1,
            ),
            np.full(nn_, 0),
        )
    )

    xyz = np.concatenate([p for p, _ in parts]).astype(np.float32)
    labels = np.concatenate([l for _, l in parts]).astype(np.int32)

    base_colors = np.array(
        [
            [0.5, 0.5, 0.5],  # noise grey
            [0.45, 0.35, 0.25],  # abutment brown
            [0.3, 0.6, 0.4],  # girder green-ish (painted steel)
            [0.7, 0.7, 0.65],  # deck concrete
            [0.8, 0.3, 0.3],  # parapet red-ish
        ],
        dtype=np.float32,
    )
    rgb = base_colors[labels] + rng.normal(0, 0.05, (len(labels), 3)).astype(
        np.float32
    )
    rgb = np.clip(rgb, 0.0, 1.0)

    perm = rng.permutation(len(labels))
    return xyz[perm], rgb[perm], labels[perm]
