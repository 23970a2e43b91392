"""Data layer of the port: the JAX package's numpy-only data layer, shared
rather than copied (LAS/H5 IO, block samplers, BlockDataset, synthetic
scenes). Importing it imports no JAX."""

from pointcloud_bridge_tpu.data import BlockDataset, read_las, write_las
from pointcloud_bridge_tpu.data.synthetic import toy_bridge_scene

__all__ = ["BlockDataset", "read_las", "toy_bridge_scene", "write_las"]
