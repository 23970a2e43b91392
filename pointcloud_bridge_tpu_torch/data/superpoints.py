"""Superpoint generation + graph construction for the SuperPointTransformer
(Highway_bridge/datasets/preprocessing/superpoint_generation.py:37-92,
graph_construction.py:5-45, datasets/pcd.py), host numpy and scipy: the
port's copy of pointcloud_bridge_tpu/data/superpoints.py.

Normals via local PCA, DBSCAN clustering over weighted [xyz, 0.5*normals,
2*geometric, 0.3*colors] features, per-superpoint feature vectors [center(3),
mean color(3), mean normal(3), mean geometric(G), std(3), count(1)], kNN
superpoint graph with [dist, feature diff, direction] edge attributes. Every
function is the JAX module's statement for statement but
``generate_superpoints``, whose DBSCAN is :func:`dbscan_labels` here
(scikit-learn is not a dependency of the port): the same labels as
``sklearn.cluster.DBSCAN``, tests/test_torch_host_tools.py holds them so.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components
from scipy.spatial import cKDTree


def compute_normals_host(points: np.ndarray, k: int = 20) -> np.ndarray:
    """kNN-PCA normals (datasets/pcd.py:126-158 equivalent)."""
    tree = cKDTree(points)
    _, idx = tree.query(points, k=min(k, len(points)))
    neigh = points[idx]  # [N, k, 3]
    centered = neigh - neigh.mean(axis=1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", centered, centered)
    w, v = np.linalg.eigh(cov)
    normals = v[:, :, 0]
    # orient upward for determinism
    flip = normals[:, 2] < 0
    normals[flip] *= -1
    return normals


def compute_geometric_features(
    points: np.ndarray, normals: np.ndarray, k: int = 20
) -> np.ndarray:
    """Per-point [verticality, planarity-proxy, local height range]."""
    tree = cKDTree(points)
    _, idx = tree.query(points, k=min(k, len(points)))
    neigh_z = points[idx][:, :, 2]
    z_range = neigh_z.max(axis=1) - neigh_z.min(axis=1)
    verticality = 1.0 - np.abs(normals[:, 2])
    neigh_n = normals[idx]
    normal_consistency = np.abs(
        np.einsum("nkc,nc->nk", neigh_n, normals)
    ).mean(axis=1)
    return np.stack([verticality, normal_consistency, z_range], axis=1)


def dbscan_labels(features: np.ndarray, eps: float, min_samples: int) -> np.ndarray:
    """DBSCAN cluster labels [N] (int64, -1 noise), those of
    ``sklearn.cluster.DBSCAN(eps, min_samples).fit(features).labels_``
    under the Euclidean metric. A point's neighbourhood is every point
    within ``eps`` (distance <= eps), itself included; a point is core when
    its neighbourhood holds at least ``min_samples`` points. Core points
    within eps of each other share a cluster, and clusters are numbered in
    the order of their lowest-index core point (scikit-learn expands one
    cluster fully, from the lowest unlabelled core point, before it starts
    the next). A point that is not core takes the lowest label among the
    clusters of its core neighbours, the first cluster to reach it; a point
    with no core neighbour is noise."""
    n = len(features)
    labels = np.full(n, -1, np.int64)
    if n == 0:
        return labels
    pairs = cKDTree(features).query_pairs(eps, output_type="ndarray")
    i, j = pairs[:, 0], pairs[:, 1]
    core = np.bincount(pairs.ravel(), minlength=n) + 1 >= min_samples
    both = core[i] & core[j]
    graph = coo_matrix((np.ones(int(both.sum()), np.int8), (i[both], j[both])), shape=(n, n))
    _, comp = connected_components(graph, directed=False)
    # a component's number: the rank of its lowest index among the core points
    first = np.full(n, n, np.int64)
    np.minimum.at(first, comp[core], np.flatnonzero(core))
    order = np.argsort(first, kind="stable")
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    labels[core] = rank[comp[core]]
    # a border point: the lowest label among its core neighbours'
    border = np.full(n, np.iinfo(np.int64).max, np.int64)
    for a, b in ((i, j), (j, i)):
        edge = core[b] & ~core[a]
        np.minimum.at(border, a[edge], labels[b[edge]])
    reached = ~core & (border < np.iinfo(np.int64).max)
    labels[reached] = border[reached]
    return labels


def generate_superpoints(
    points: np.ndarray,
    colors: np.ndarray,
    normals: np.ndarray,
    min_points: int = 20,
    eps: float = 0.1,
) -> Tuple[np.ndarray, np.ndarray]:
    """DBSCAN superpoints over weighted features; returns (labels [N] with -1
    noise, superpoint_features [S, 3+3+3+G+3+1])."""
    geometric = compute_geometric_features(points, normals)
    features = np.concatenate(
        [points, normals * 0.5, geometric * 2.0, colors * 0.3], axis=1
    )
    labels = dbscan_labels(features, eps=eps, min_samples=min_points)

    sp_features = []
    for label in np.unique(labels):
        if label == -1:
            continue
        m = labels == label
        sp_features.append(
            np.concatenate(
                [
                    points[m].mean(axis=0),
                    colors[m].mean(axis=0),
                    normals[m].mean(axis=0),
                    geometric[m].mean(axis=0),
                    points[m].std(axis=0),
                    [m.sum()],
                ]
            )
        )
    return labels, np.asarray(sp_features)


def build_graph(
    superpoint_features: np.ndarray, k_neighbors: int = 8
) -> Tuple[np.ndarray, np.ndarray]:
    """kNN superpoint graph; returns (edge_index [2, E], edge_attr [E, A])
    with A = 1 (dist) + F (feature diff) + 3 (direction)."""
    centers = superpoint_features[:, :3]
    s = len(centers)
    k = min(k_neighbors + 1, s)
    tree = cKDTree(centers)
    dist, idx = tree.query(centers, k=k)
    edges, attrs = [], []
    for i in range(s):
        for j, d in zip(idx[i][1:], dist[i][1:]):
            feat = np.concatenate(
                [
                    [d],
                    superpoint_features[i] - superpoint_features[j],
                    centers[j] - centers[i],
                ]
            )
            edges.append([i, j])
            attrs.append(feat)
            edges.append([j, i])
            attrs.append(feat)
    return np.asarray(edges, np.int32).T, np.asarray(attrs, np.float32)


def pad_graph(
    x: np.ndarray,
    edge_index: np.ndarray,
    edge_attr: np.ndarray,
    max_nodes: int,
    max_edges: int,
):
    """Pad a graph to fixed sizes for jit (returns arrays + masks)."""
    s, f = x.shape
    e = edge_index.shape[1]
    x_p = np.zeros((max_nodes, f), x.dtype)
    x_p[:s] = x
    ei_p = np.zeros((2, max_edges), np.int32)
    ei_p[:, :e] = edge_index[:, :max_edges]
    ea_p = np.zeros((max_edges, edge_attr.shape[1]), edge_attr.dtype)
    ea_p[:e] = edge_attr[:max_edges]
    node_mask = np.zeros(max_nodes, bool)
    node_mask[:s] = True
    edge_mask = np.zeros(max_edges, bool)
    edge_mask[: min(e, max_edges)] = True
    return x_p, ei_p, ea_p, node_mask, edge_mask


def radius_graph(points: np.ndarray, radius: float, max_degree: int = 32):
    """Host-side radius graph (utils/graph_utils.py:6-63 capability):
    returns edge_index [2, E] of pairs within `radius` (bidirectional,
    capped at max_degree neighbors per node)."""
    tree = cKDTree(points)
    pairs = tree.query_ball_point(points, r=radius)
    edges = []
    for i, nbrs in enumerate(pairs):
        count = 0
        for j in nbrs:
            if j == i:
                continue
            edges.append([i, j])
            count += 1
            if count >= max_degree:
                break
    if not edges:
        return np.zeros((2, 0), np.int32)
    return np.asarray(edges, np.int32).T


def local_frames(points: np.ndarray, k: int = 20):
    """Per-point local coordinate frames from kNN PCA
    (utils/geometry.py:5-50): returns [N, 3, 3] rotation matrices with rows =
    (principal, secondary, normal) directions."""
    tree = cKDTree(points)
    _, idx = tree.query(points, k=min(k, len(points)))
    neigh = points[idx]
    centered = neigh - neigh.mean(axis=1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", centered, centered)
    w, v = np.linalg.eigh(cov)  # ascending
    frames = np.stack([v[:, :, 2], v[:, :, 1], v[:, :, 0]], axis=1)
    return frames
