"""Format converters (Highway_bridge/tools/convert_las_h5.py:8-34,
npz2las.py:54-107, Partsize tool_utils/txt2las.py:7-38)."""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from ..data.h5io import read_h5, write_h5
from ..data.lasio import read_las, write_las


def las_to_h5(las_path: str, h5_path: str) -> None:
    """LAS -> HDF5 {points, colors(/65535), labels} (convert_las_h5.py)."""
    las = read_las(las_path)
    colors = las.colors01
    if colors is None:
        colors = np.zeros((len(las.xyz), 3), np.float32)
    write_h5(h5_path, las.xyz.astype(np.float32), colors, las.classification)


def h5_to_las(h5_path: str, las_path: str) -> None:
    pts, cols, labels = read_h5(h5_path)
    write_las(las_path, pts, cols, labels)


def npz_blocks_to_las(npz_paths, las_path: str) -> None:
    """Merge per-block NPZ caches back into one LAS (tools/npz2las.py)."""
    all_pts, all_cols, all_labels = [], [], []
    for p in npz_paths:
        z = np.load(p)
        pts = z["original_points"] if "original_points" in z else z["points"]
        cols = z["colors"] if "colors" in z else np.zeros_like(pts)
        labels = z["labels"] if "labels" in z else np.zeros(len(pts), np.int64)
        if pts.ndim == 3:  # stacked blocks
            pts, cols, labels = (
                pts.reshape(-1, 3),
                cols.reshape(-1, 3),
                labels.reshape(-1),
            )
        if cols.max() > 1.5:  # renormalize 0-255 colors
            cols = cols / 255.0
        all_pts.append(pts)
        all_cols.append(cols)
        all_labels.append(labels)
    write_las(
        las_path,
        np.concatenate(all_pts),
        np.concatenate(all_cols),
        np.concatenate(all_labels).astype(np.uint8),
    )


def txt_to_las(txt_path: str, las_path: str) -> None:
    """xyzrgb(+label) whitespace text -> LAS (tool_utils/txt2las.py)."""
    arr = np.loadtxt(txt_path)
    xyz = arr[:, :3]
    rgb = arr[:, 3:6] if arr.shape[1] >= 6 else None
    if rgb is not None and rgb.max() > 1.5:
        rgb = rgb / 255.0
    labels = arr[:, 6].astype(np.uint8) if arr.shape[1] >= 7 else None
    write_las(las_path, xyz, rgb, labels)


def preview_las(las_path: str, out_png: str, max_points: int = 100_000,
                color_by: str = "label", seed: int = 0) -> str:
    """Static 3D preview of a LAS file, colored by label or rgb — the
    headless equivalent of npz2las.py:108-176's Open3D viewer (Open3D is not
    available in this environment; a saved figure replaces the window)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    las = read_las(las_path)
    xyz = las.xyz
    rng = np.random.default_rng(seed)
    if len(xyz) > max_points:
        sel = rng.choice(len(xyz), max_points, replace=False)
        xyz = xyz[sel]
        cls = las.classification[sel]
        rgb = None if las.rgb is None else las.rgb[sel]
    else:
        cls, rgb = las.classification, las.rgb
    fig = plt.figure(figsize=(10, 8))
    ax = fig.add_subplot(111, projection="3d")
    if color_by == "rgb" and rgb is not None:
        ax.scatter(xyz[:, 0], xyz[:, 1], xyz[:, 2],
                   c=rgb.astype(np.float64) / 65535.0, s=0.5)
    else:
        ax.scatter(xyz[:, 0], xyz[:, 1], xyz[:, 2], c=cls, s=0.5, cmap="tab10")
    ax.set_title(f"{las_path} ({len(xyz)} pts shown)")
    fig.tight_layout()
    fig.savefig(out_png, dpi=150)
    plt.close(fig)
    return out_png


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="point-cloud format converters")
    ap.add_argument("mode", choices=["las2h5", "h52las", "npz2las", "txt2las"])
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("--preview", metavar="PNG",
                    help="also save a 3D scatter preview of the produced LAS")
    ap.add_argument("--preview-color", choices=["label", "rgb"], default="label")
    args = ap.parse_args(argv)
    if args.mode == "las2h5":
        las_to_h5(args.src, args.dst)
    elif args.mode == "h52las":
        h5_to_las(args.src, args.dst)
    elif args.mode == "npz2las":
        npz_blocks_to_las(sorted(glob.glob(args.src)), args.dst)
    elif args.mode == "txt2las":
        txt_to_las(args.src, args.dst)
    if args.preview and args.dst.endswith(".las"):
        preview_las(args.dst, args.preview, color_by=args.preview_color)


if __name__ == "__main__":
    main()
