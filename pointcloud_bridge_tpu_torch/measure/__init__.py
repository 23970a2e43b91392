"""Geometric measurement pipeline (L5, Partsize-identical WL identification)
on the card: the JAX package's measure/ with its scikit-learn stages
written again in PyTorch (wl_iden.py)."""

from .wl_iden import (
    ransac_plane_fit,
    project_to_plane,
    align_to_principal_axes,
    detect_and_trim_edges,
    minimum_bounding_rectangle,
    adaptive_voxel_size,
    data_voxel,
    isolation_forest_outlier_removal,
    lof_outlier_removal,
    dbscan_outlier_removal,
    calculate_dimensions,
    process_bridge_deck,
    process_raw,
    evaluate_result,
    run_wl_identification,
    save_overlay_figure,
)

__all__ = [
    "ransac_plane_fit",
    "project_to_plane",
    "align_to_principal_axes",
    "detect_and_trim_edges",
    "minimum_bounding_rectangle",
    "adaptive_voxel_size",
    "data_voxel",
    "isolation_forest_outlier_removal",
    "lof_outlier_removal",
    "dbscan_outlier_removal",
    "calculate_dimensions",
    "process_bridge_deck",
    "process_raw",
    "evaluate_result",
    "run_wl_identification",
    "save_overlay_figure",
]
