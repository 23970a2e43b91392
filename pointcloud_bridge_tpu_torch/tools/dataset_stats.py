"""Dataset statistics & comparison tool.

Capability parity with the reference's statistics/dataset-comparison
analysis configs (Highway_bridge/config/statistics_config.yaml and
config/dataset_comparison_config.yaml — both consumed by a notebook the
reference never committed; the configs pin the contract: per-dataset
per-class statistics, a CSV like bridge_statistics.csv, and styled
comparison charts with a fixed color list).

Outputs per dataset:
  - per-file rows: points, xy extent, z range, density (pts/m^2 of the xy
    bounding box), per-class counts and proportions;
  - a dataset summary row (totals + pooled class mix);
and across datasets:
  - `<out>/dataset_statistics.csv` (one row per file + per-dataset TOTAL),
  - `<out>/class_distribution.png` grouped per-class proportion bars, one
    group color per dataset (config `plot.colors` or matplotlib defaults).

Usage:
  python -m pointcloud_bridge_tpu_torch.tools.dataset_stats \
      --config configs/statistics_config.yaml --classes road_5class \
      --out out_dir name1=path/to/las_dir name2=other_dir
"""

from __future__ import annotations

import argparse
import csv
import glob
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..data.lasio import read_las
from ..data.h5io import read_h5


def _load_labels_xyz(path: str):
    if path.endswith((".h5", ".hdf5")):
        xyz, _, labels = read_h5(path)
        return np.asarray(xyz, np.float64), np.asarray(labels, np.int64)
    las = read_las(path)
    return las.xyz, las.classification.astype(np.int64)


def file_statistics(path: str, num_classes: int) -> Dict[str, object]:
    """Per-file stats row: counts, extent, density, class histogram."""
    xyz, labels = _load_labels_xyz(path)
    n = len(xyz)
    mins = xyz.min(axis=0) if n else np.zeros(3)
    maxs = xyz.max(axis=0) if n else np.zeros(3)
    area = float((maxs[0] - mins[0]) * (maxs[1] - mins[1]))
    hist = np.bincount(labels.clip(0, num_classes - 1), minlength=num_classes)
    return {
        "file": os.path.basename(path),
        "points": n,
        "extent_x": float(maxs[0] - mins[0]),
        "extent_y": float(maxs[1] - mins[1]),
        "z_range": float(maxs[2] - mins[2]),
        "density_pts_per_m2": (n / area) if area > 0 else 0.0,
        "class_counts": hist,
    }


def dataset_statistics(
    paths: Sequence[str], num_classes: int
) -> List[Dict[str, object]]:
    rows = [file_statistics(p, num_classes) for p in sorted(paths)]
    if rows:
        total = {
            "file": "TOTAL",
            "points": int(sum(r["points"] for r in rows)),
            "extent_x": float(max(r["extent_x"] for r in rows)),
            "extent_y": float(max(r["extent_y"] for r in rows)),
            "z_range": float(max(r["z_range"] for r in rows)),
            "density_pts_per_m2": float(
                np.mean([r["density_pts_per_m2"] for r in rows])
            ),
            "class_counts": np.sum(
                [r["class_counts"] for r in rows], axis=0
            ),
        }
        rows.append(total)
    return rows


def _expand(path: str) -> List[str]:
    if os.path.isdir(path):
        out: List[str] = []
        for pat in ("*.las", "*.h5", "*.hdf5"):
            out += glob.glob(os.path.join(path, pat))
        return out
    return [path]


def write_statistics_csv(
    out_csv: str,
    per_dataset: Dict[str, List[Dict[str, object]]],
    class_names: Dict[int, str],
) -> None:
    num_classes = len(class_names)
    cols = (
        ["dataset", "file", "points", "extent_x", "extent_y", "z_range",
         "density_pts_per_m2"]
        + [f"count_{class_names[i]}" for i in range(num_classes)]
        + [f"prop_{class_names[i]}" for i in range(num_classes)]
    )
    os.makedirs(os.path.dirname(out_csv) or ".", exist_ok=True)
    with open(out_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(cols)
        for name, rows in per_dataset.items():
            for r in rows:
                counts = np.asarray(r["class_counts"], np.int64)
                tot = max(int(counts.sum()), 1)
                w.writerow(
                    [name, r["file"], r["points"],
                     f"{r['extent_x']:.3f}", f"{r['extent_y']:.3f}",
                     f"{r['z_range']:.3f}",
                     f"{r['density_pts_per_m2']:.2f}"]
                    + [int(c) for c in counts]
                    + [f"{c / tot:.6f}" for c in counts]
                )


def plot_class_distribution(
    out_png: str,
    per_dataset: Dict[str, List[Dict[str, object]]],
    class_names: Dict[int, str],
    colors: Optional[Sequence[str]] = None,
    dpi: int = 200,
) -> None:
    """Grouped per-class proportion bars, one color per dataset (the
    dataset_comparison_config contract: fixed color list + dpi)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    num_classes = len(class_names)
    names = list(per_dataset)
    width = 0.8 / max(len(names), 1)
    fig, ax = plt.subplots(figsize=(max(6, 1.5 * num_classes), 4))
    xs = np.arange(num_classes)
    for i, name in enumerate(names):
        total_row = per_dataset[name][-1]
        counts = np.asarray(total_row["class_counts"], np.float64)
        props = counts / max(counts.sum(), 1.0)
        kw = {}
        if colors:
            kw["color"] = colors[i % len(colors)]
        ax.bar(xs + (i - (len(names) - 1) / 2) * width, props, width,
               label=name, **kw)
    ax.set_xticks(xs)
    ax.set_xticklabels(
        [class_names[i] for i in range(num_classes)], rotation=30, ha="right"
    )
    ax.set_ylabel("class proportion")
    ax.set_title("Dataset class-distribution comparison")
    ax.legend()
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_png) or ".", exist_ok=True)
    fig.savefig(out_png, dpi=dpi)
    plt.close(fig)


def compare_datasets(
    datasets: Dict[str, Sequence[str]],
    class_names: Dict[int, str],
    out_dir: str,
    colors: Optional[Sequence[str]] = None,
    dpi: int = 200,
) -> Dict[str, List[Dict[str, object]]]:
    """Full pipeline: stats per dataset -> CSV + comparison chart."""
    num_classes = len(class_names)
    per_dataset = {
        name: dataset_statistics(paths, num_classes)
        for name, paths in datasets.items()
    }
    write_statistics_csv(
        os.path.join(out_dir, "dataset_statistics.csv"), per_dataset,
        class_names,
    )
    plot_class_distribution(
        os.path.join(out_dir, "class_distribution.png"), per_dataset,
        class_names, colors=colors, dpi=dpi,
    )
    return per_dataset


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default="configs/statistics_config.yaml")
    ap.add_argument("--classes", default="road_5class",
                    help="class-map key inside the config")
    ap.add_argument("--out", required=True)
    ap.add_argument("datasets", nargs="+",
                    help="name=path (dir of .las/.h5 or a single file)")
    args = ap.parse_args(argv)

    import yaml

    with open(args.config) as f:
        cfg = yaml.safe_load(f)
    cmap = {int(k): str(v) for k, v in cfg[args.classes].items()}
    plot_cfg = cfg.get("plot", {}) or {}

    datasets = {}
    for spec in args.datasets:
        name, _, path = spec.partition("=")
        if not path:
            name, path = os.path.basename(spec.rstrip("/")), spec
        datasets[name] = _expand(path)

    per = compare_datasets(
        datasets, cmap, args.out,
        colors=plot_cfg.get("colors"), dpi=int(plot_cfg.get("dpi", 200)),
    )
    for name, rows in per.items():
        tot = rows[-1]
        print(f"{name}: {len(rows) - 1} files, {tot['points']} points")


if __name__ == "__main__":
    main()
