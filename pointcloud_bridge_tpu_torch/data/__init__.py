"""Data layer of the port (L0 file IO + L1 block samplers): the port's own
numpy-only copy of pointcloud_bridge_tpu/data, with the same exports."""

from .lasio import LasData, read_las, read_las_xyzrgbl, write_las
from .h5io import read_h5, write_h5
from .blocks import (
    Block,
    normalize_points,
    points_in_block,
    stratified_sample_indices,
    weighted_stratified_sample_indices,
    boosted_class_proportions,
    make_training_blocks,
    s3dis_column_block,
    whole_scene_grid_blocks,
    scene_labelweights,
    split_files,
)
from .dataset import BlockDataset

__all__ = [
    "LasData",
    "read_las",
    "read_las_xyzrgbl",
    "write_las",
    "read_h5",
    "write_h5",
    "Block",
    "normalize_points",
    "points_in_block",
    "stratified_sample_indices",
    "weighted_stratified_sample_indices",
    "boosted_class_proportions",
    "make_training_blocks",
    "s3dis_column_block",
    "whole_scene_grid_blocks",
    "scene_labelweights",
    "split_files",
    "BlockDataset",
]
