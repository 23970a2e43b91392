"""Voxel-grid downsampling of LAS scenes with nearest-neighbor label/color
transfer and before/after density stats (tools/downsamp.py:13-224,
tool_utils/voxel_downsampling.py:19-93). The reference uses Open3D; this is a
numpy voxel-centroid implementation + cKDTree transfer."""

from __future__ import annotations

import argparse
import os
from typing import Tuple

import numpy as np
from scipy.spatial import cKDTree

from ..data.lasio import read_las, write_las


def voxel_downsample(
    xyz: np.ndarray, voxel_size: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Voxel-centroid downsampling. Returns (centroids [M,3], voxel id per
    input point [N])."""
    coords = np.floor(xyz / voxel_size).astype(np.int64)
    _, inverse, counts = np.unique(
        coords, axis=0, return_inverse=True, return_counts=True
    )
    m = counts.shape[0]
    centroids = np.zeros((m, 3))
    np.add.at(centroids, inverse, xyz)
    centroids /= counts[:, None]
    return centroids, inverse


def downsample_las(
    src: str, dst: str, voxel_size: float = 0.02
) -> Tuple[int, int]:
    """Downsample one LAS; labels/colors transferred from the nearest
    original point (downsamp.py KDTree transfer). Returns (n_in, n_out)."""
    las = read_las(src)
    centroids, _ = voxel_downsample(las.xyz, voxel_size)
    tree = cKDTree(las.xyz)
    _, nearest = tree.query(centroids, k=1)
    colors = las.colors01[nearest] if las.rgb is not None else None
    labels = las.classification[nearest]
    write_las(dst, centroids, colors, labels)
    return len(las.xyz), len(centroids)


def analyze_point_density(xyz: np.ndarray, sample: int = 1000, seed: int = 0):
    """Mean nearest-neighbor distance + bbox density (downsamp.py:156-224)."""
    rng = np.random.default_rng(seed)
    pts = xyz[rng.choice(len(xyz), min(sample, len(xyz)), replace=False)]
    tree = cKDTree(pts)
    d, _ = tree.query(pts, k=2)
    bbox = xyz.max(0) - xyz.min(0)
    return {
        "n_points": len(xyz),
        "mean_nn_distance": float(np.mean(d[:, 1])),
        "density_per_m3": float(len(xyz) / max(np.prod(bbox), 1e-9)),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="voxel downsample LAS files")
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("--voxel-size", type=float, default=0.02)
    args = ap.parse_args(argv)
    if os.path.isdir(args.src):
        os.makedirs(args.dst, exist_ok=True)
        for f in sorted(os.listdir(args.src)):
            if f.endswith(".las"):
                n_in, n_out = downsample_las(
                    os.path.join(args.src, f),
                    os.path.join(args.dst, f),
                    args.voxel_size,
                )
                print(f"{f}: {n_in} -> {n_out}")
    else:
        n_in, n_out = downsample_las(args.src, args.dst, args.voxel_size)
        print(f"{n_in} -> {n_out}")


if __name__ == "__main__":
    main()
