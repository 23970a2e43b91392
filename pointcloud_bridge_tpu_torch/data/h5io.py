"""HDF5 point-cloud IO — the {points, colors, labels} gzip dataset contract of
Highway_bridge/tools/convert_las_h5.py:8-34 and utils/BriPCDMulti_new.py."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def write_h5(
    path: str, points: np.ndarray, colors: np.ndarray, labels: np.ndarray
) -> None:
    import h5py

    with h5py.File(path, "w") as f:
        f.create_dataset("points", data=np.asarray(points, np.float32), compression="gzip")
        f.create_dataset("colors", data=np.asarray(colors, np.float32), compression="gzip")
        f.create_dataset("labels", data=np.asarray(labels, np.int64), compression="gzip")


def read_h5(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    import h5py

    with h5py.File(path, "r") as f:
        points = np.array(f["points"])
        colors = np.array(f["colors"])
        labels = np.array(f["labels"]) if "labels" in f else np.zeros(len(points), np.int64)
    return points, colors, labels
