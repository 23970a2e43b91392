"""Predicted-LAS export (inference.py:787-810 create_new_las_file contract:
point_format=3, rgb x 65535, classification = predicted label)."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..data.lasio import write_las


def export_predicted_las(
    out_path: str,
    xyz: np.ndarray,
    rgb01: Optional[np.ndarray],
    predictions: np.ndarray,
) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    write_las(out_path, xyz, rgb01, predictions.astype(np.uint8))
    return out_path
