"""Point-cloud ops of the PyTorch port, channel-last like the JAX package.

Each op that the JAX package runs as a Pallas kernel has a hand-written CUDA
kernel here (csrc/) and a plain PyTorch version beside it in the same
module: a CPU tensor takes the plain version, a CUDA tensor the kernel.
``ops.attention`` is the attention module (``ops.attention.attention`` the op).
"""

from .core import index_points, pairwise_sq_dist, square_distance
from .grouping import (
    edge_conv_graph_feature,
    group_points,
    knn,
    knn_set,
    knn_with_distance,
    query_ball_point,
    sample_and_group,
)
from .interpolate import three_nn_interpolate
from .sampling import farthest_point_sample
from .structure import (
    eigh3x3,
    eigvals3_from_entries,
    estimate_normals,
    knn_relative_positions,
    local_covariance,
    local_structure_features,
    min_eigvec3x3,
)

__all__ = [
    "edge_conv_graph_feature",
    "eigh3x3",
    "eigvals3_from_entries",
    "estimate_normals",
    "farthest_point_sample",
    "group_points",
    "index_points",
    "knn",
    "knn_relative_positions",
    "knn_set",
    "knn_with_distance",
    "local_covariance",
    "local_structure_features",
    "min_eigvec3x3",
    "pairwise_sq_dist",
    "query_ball_point",
    "sample_and_group",
    "square_distance",
    "three_nn_interpolate",
]
