"""Deck width/length identification on the card (the JAX package's
measure/wl_iden.py, Partsize-identical/WL_iden.py).

Pred branch (process_bridge_deck): voxel downsample -> RANSAC plane fit on
z(x, y) -> directional isolation forest (PCA length axis relaxed 0.5x,
width axis strict) -> LOF -> xy projection -> density-histogram edge trim
-> convex-hull minimum bounding rectangle (rotating calipers) ->
edge-point-projection refinement clipped to +-5%. Raw branch (process_raw):
projection -> PCA alignment -> trim -> MBR -> refinement.

The JAX package runs these stages on the host with scikit-learn. Here:

- host stages (projection, trim, MBR, dimensions, voxel, the adaptive voxel
  size, the error) are the JAX package's numpy and scipy code;
- PCA, RANSAC, the isolation forest, LOF and DBSCAN's noise mask are
  PyTorch on ``device`` (the card unless the caller passes "cpu"),
  computed in float64 as scikit-learn 1.9 computes them (inputs are taken
  in float64, where scikit-learn keeps a float32 input in float32; PCA's
  covariance from centred points, see ``pca_fit_transform``); their
  random draws are made on the host from the same generators scikit-learn
  uses, so the card and the CPU run the same trials;
- the neighbour searches of LOF, of the adaptive LOF parameters and of
  DBSCAN go through the exact k-NN kernel (K5, ops/grouping.py
  ``knn_with_distance``) over float32 coordinates centred in float64
  first; the picked distances are then recomputed in float64. On the CPU
  the same picks come from the plain version in chunks of queries
  (``knn_picks``).
"""

from __future__ import annotations

import csv
import os
import time
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from scipy.spatial import ConvexHull, cKDTree

from ..ops.core import pairwise_sq_dist
from ..ops.grouping import KNN_MAX_K, knn_with_distance


def _device(device) -> torch.device:
    """The device a stage runs on: "cuda" (the default) must exist, "cpu"
    is for tests; a missing card is train/loop.py's resolve_device error."""
    from ..train.loop import resolve_device

    return device if isinstance(device, torch.device) else resolve_device(str(device))


def _f64(points: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(points, np.float64), device=dev)


def np_percentile(values: torch.Tensor, q: float) -> float:
    """``np.percentile(values, q)`` (method "linear") of a 1-D tensor: a
    sort on its device, then numpy's virtual index and its lerp (the upper
    form from gamma 0.5 on) on the host."""
    n = values.numel()
    virtual = (n - 1) * np.true_divide(q, 100)
    srt = values.sort().values
    if virtual >= n - 1:
        return float(srt[-1])
    if virtual < 0:
        return float(srt[0])
    prev = int(np.floor(virtual))
    gamma = np.float64(virtual - np.floor(virtual))
    a, b = (np.float64(v) for v in srt[prev:prev + 2].cpu().numpy())
    diff = b - a
    return float(b - diff * (1 - gamma) if gamma >= 0.5 else a + diff * gamma)


# ------------------------------------------------------------ neighbours

# candidates beyond k that the CPU path takes from its tree
_TIE_SLACK = 8
# distances a chunk of the CPU path's brute force holds
_CHUNK_PAIRS = 1 << 24
# a float32 squared distance in the direct form is within 5 roundings
# (2^-24 each) of the exact one; the CPU path's margin for its tree's picks
_FLOAT32_MARGIN = 1e-6


def knn_picks(xyz: torch.Tensor, query: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k nearest of ``xyz`` [N, 3] to each of ``query`` [S, 3] (float32,
    the query itself included where it is a point) -> (d2 [S, k] float32,
    idx [S, k] int64), nearest first, equal distances to the lower index:
    ``knn_plain``'s answer, distances in its direct float32 form. On the card
    one K5 launch (k <= KNN_MAX_K, else ValueError). On the CPU the same
    answer without the [S, N] distances of the plain version: a k-d tree
    (scipy) picks k + _TIE_SLACK candidates a query in float64, their
    float32 distances are ordered by (distance, index), and a query whose
    k-th float32 distance is not below its farthest candidate's by
    _FLOAT32_MARGIN (a tie the tree may have cut) is answered by the plain
    version, in chunks of queries."""
    if xyz.device.type != "cpu":
        if k > KNN_MAX_K:
            raise ValueError(f"the k-NN kernel takes k <= {KNN_MAX_K}, got k={k}")
        d2, idx = knn_with_distance(xyz[None].contiguous(), query[None].contiguous(), k)
        return d2[0], idx[0].long()
    n, s = xyz.shape[0], query.shape[0]
    if not 1 <= k <= n:
        raise ValueError(f"knn: expected 1 <= k <= N, got k={k}, N={n}")
    m = min(n, k + _TIE_SLACK)
    far, cand = cKDTree(xyz.double().numpy()).query(query.double().numpy(), k=m, workers=-1)
    cand = torch.from_numpy(np.asarray(cand, np.int64).reshape(s, m)).sort(1).values
    d2 = _direct_d2(query, xyz, cand)
    d2, pos = d2.sort(dim=1, stable=True)
    cand = cand.gather(1, pos)
    d2, cand = d2[:, :k].contiguous(), cand[:, :k].contiguous()
    if m < n:
        far2 = torch.from_numpy(np.asarray(far, np.float64).reshape(s, m)[:, -1] ** 2)
        redo = (d2[:, -1].double() >= far2 * (1 - _FLOAT32_MARGIN)).nonzero()[:, 0]
        step = max(1, _CHUNK_PAIRS // n)
        for at in range(0, len(redo), step):
            rows = redo[at:at + step]
            vals, order = pairwise_sq_dist(query[None, rows], xyz[None])[0].sort(dim=1, stable=True)
            d2[rows], cand[rows] = vals[:, :k], order[:, :k]
    return d2, cand


def _direct_d2(query: torch.Tensor, xyz: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """float32 squared distances [S, m] from each query to its ``idx`` in
    ``pairwise_sq_dist``'s direct form: (dx*dx + dy*dy) + dz*dz of query -
    point, each op rounded on its own."""
    pts = xyz[idx]
    d = query[:, None, 0] - pts[..., 0]
    acc = d * d
    for c in range(1, xyz.shape[1]):
        d = query[:, None, c] - pts[..., c]
        acc += d * d
    return acc


def _centred32(x64: torch.Tensor) -> torch.Tensor:
    """float32 coordinates for K5, centred in float64 first: georeferenced
    coordinates of 10^5-10^6 m have a float32 spacing above the voxel."""
    return (x64 - x64.mean(0)).float().contiguous()


def _distances(x64: torch.Tensor, query64: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Euclidean distances [S, k] in float64 from each query to its picks,
    the squares added in axis order as scikit-learn's trees add them."""
    diff = query64[:, None, :] - x64[idx]
    d2 = diff[..., 0] * diff[..., 0]
    for c in range(1, x64.shape[1]):
        d2 = d2 + diff[..., c] * diff[..., c]
    return d2.sqrt()


def _drop_self(idx: torch.Tensor) -> torch.Tensor:
    """[S, k + 1] -> [S, k]: each row without its own index, as
    ``kneighbors()`` without X drops it; a row that does not hold it
    (duplicates ranked ahead) drops its first column."""
    s = idx.shape[0]
    keep = idx != torch.arange(s, device=idx.device)[:, None]
    keep[:, 0] &= ~keep.all(1)
    return idx[keep].view(s, idx.shape[1] - 1)


# ------------------------------------------------------------------ PCA


class PCAFit(NamedTuple):
    """What the chain reads of a fitted scikit-learn PCA."""
    components_: torch.Tensor
    mean_: torch.Tensor
    explained_variance_: torch.Tensor
    explained_variance_ratio_: torch.Tensor


def pca_fit_transform(x: torch.Tensor, n_components: int) -> Tuple[torch.Tensor, PCAFit]:
    """PCA(n_components).fit_transform of float64 [n, d] as scikit-learn 1.9
    computes it: "covariance_eigh" for tall data (d <= 1000, n >= 10 d: the
    covariance over n - 1, eigh, descending, negative eigenvalues clipped),
    else the SVD of the centred data; signs by svd_flip on the rows of Vt
    (the largest |entry| of each row made positive); explained variance
    ratios of all components. One departure: the covariance is formed from
    the centred points, where scikit-learn forms the uncentred Gram matrix
    less n mean mean^T, which at georeferenced coordinates (10^5-10^6 m)
    cancels away most of a deck's variance in float64 (a transform off by
    millimetres on a 20 m deck at 4e6 m)."""
    n, d = x.shape
    mean = x.mean(0)
    xc = x - mean
    if d <= 1000 and n >= 10 * d:
        evals, evecs = torch.linalg.eigh(xc.T @ xc / (n - 1))
        evals, vt = evals.flip(0).clamp(min=0.0), evecs.flip(1).T
        u = s = None
    else:
        u, s, vt = torch.linalg.svd(xc, full_matrices=False)
        evals = s**2 / (n - 1)
    pick = vt.abs().argmax(1)
    signs = torch.sign(vt.gather(1, pick[:, None]))
    vt = vt * signs
    fit = PCAFit(vt[:n_components], mean, evals[:n_components],
                 (evals / evals.sum())[:n_components])
    if u is None:
        out = xc @ fit.components_.T
    else:
        out = (u * signs[:, 0][None, :])[:, :n_components] * s[:n_components]
    return out, fit


def align_to_principal_axes(points: np.ndarray, device="cuda") -> np.ndarray:
    """PCA(n_components=2).fit(points).transform(points) (WL_iden.py:57-62)."""
    x = _f64(points, _device(device))
    _, fit = pca_fit_transform(x, 2)
    return ((x - fit.mean_) @ fit.components_.T).cpu().numpy()


def directional_outlier_detection(
    points: np.ndarray, contamination: float = 0.1, is_length_direction: bool = True,
    device="cuda",
):
    """PCA-transformed coordinates + axis choice + relaxed/strict
    contamination (WL_iden.py:233-256). Returns (transformed [n, d] numpy,
    axis, contamination, PCAFit)."""
    transformed, fit = pca_fit_transform(_f64(points, _device(device)), points.shape[1])
    ratio = fit.explained_variance_ratio_.cpu().numpy()
    main_idx = 0 if ratio[0] > ratio[1] else 1
    direction_idx = main_idx if is_length_direction else (1 - main_idx)
    adjusted = contamination * (0.5 if is_length_direction else 1.0)
    return transformed.cpu().numpy(), direction_idx, adjusted, fit


# --------------------------------------------------------------- RANSAC

# scikit-learn's RANSACRegressor defaults that the chain keeps
RANSAC_MIN_SAMPLES = 3
RANSAC_STOP_PROBABILITY = 0.99
RANSAC_SEED = 42
# trials scored a pass on the device: the first pass is small (a deck's
# inlier share ends the search after a handful), later ones double
RANSAC_CHUNKS = (32, 64, 128, 256)
_EPSILON = np.spacing(1)


def dynamic_max_trials(n_inliers, n_samples, min_samples, probability):
    """scikit-learn's _dynamic_max_trials (linear_model/_ransac.py:47)."""
    inlier_ratio = n_inliers / float(n_samples)
    nom = max(_EPSILON, 1 - probability)
    denom = max(_EPSILON, 1 - inlier_ratio**min_samples)
    if nom == 1:
        return 0
    if denom == 1:
        return float("inf")
    return abs(float(np.ceil(np.log(nom) / np.log(denom))))


def sample_without_replacement(n_population: int, n_samples: int,
                               rng: np.random.RandomState) -> np.ndarray:
    """scikit-learn's sample_without_replacement (utils/_random.pyx, method
    "auto") on ``rng``: a permutation where 0.01 < n_samples / n_population
    < 0.99, else tracking selection below a ratio of 0.2 (rejection over
    successive ``randint`` draws) and reservoir sampling above it."""
    ratio = n_samples / n_population if n_population else 1.0
    if 0.01 < ratio < 0.99:
        return rng.permutation(n_population)[:n_samples]
    if ratio < 0.2:
        out, seen = [], set()
        for _ in range(n_samples):
            j = rng.randint(n_population)
            while j in seen:
                j = rng.randint(n_population)
            seen.add(j)
            out.append(j)
        return np.asarray(out, np.int64)
    out = np.arange(n_samples)
    for i in range(n_samples, n_population):
        j = rng.randint(0, i + 1)
        if j < n_samples:
            out[j] = i
    return out


def _plane_models(xs: torch.Tensor, zs: torch.Tensor) -> torch.Tensor:
    """LinearRegression().fit on each trial's subset [T, m, 2] -> [T, 3]
    (a, b, c) of z = a x + b y + c: the minimum-norm least squares of the
    centred system, as scipy's lstsq (gelsd) with scikit-learn's cutoff
    max(m, 2) * eps on the singular values; the centred 2x2 normal equations
    solved directly, and along the one direction left where the subset is
    collinear."""
    xm, zm = xs.mean(1), zs.mean(1)
    xc, zc = xs - xm[:, None], zs - zm[:, None]
    sxx = (xc[..., 0] * xc[..., 0]).sum(1)
    syy = (xc[..., 1] * xc[..., 1]).sum(1)
    sxy = (xc[..., 0] * xc[..., 1]).sum(1)
    bx = (xc[..., 0] * zc).sum(1)
    by = (xc[..., 1] * zc).sum(1)
    det = sxx * syy - sxy * sxy
    half_tr = (sxx + syy) / 2
    root = (((sxx - syy) / 2) ** 2 + sxy * sxy).sqrt()
    lmax, lmin = half_tr + root, (half_tr - root).clamp(min=0.0)
    cutoff = max(xs.shape[1], 2) * np.finfo(np.float64).eps
    full = lmin.sqrt() > cutoff * lmax.sqrt()
    safe = torch.where(full, det, torch.ones_like(det))
    a = (syy * bx - sxy * by) / safe
    b = (sxx * by - sxy * bx) / safe
    # rank one: the eigenvector of lmax, (sxy, lmax - sxx) or (lmax - syy, sxy)
    vx = torch.where(sxx >= syy, lmax - syy, sxy)
    vy = torch.where(sxx >= syy, sxy, lmax - sxx)
    norm = (vx * vx + vy * vy).sqrt()
    live = (norm > 0) & (lmax > 0)
    vx, vy = (torch.where(live, v / torch.where(live, norm, 1.0), 0.0) for v in (vx, vy))
    proj = (vx * bx + vy * by) / torch.where(live, lmax, 1.0)
    a = torch.where(full, a, proj * vx)
    b = torch.where(full, b, proj * vy)
    c = zm - (xm[:, 0] * a + xm[:, 1] * b)
    return torch.stack([a, b, c], 1)


def ransac_inlier_mask(
    points: np.ndarray, max_trials: int = 2000, residual_threshold: float = 0.1,
    device="cuda",
) -> Tuple[np.ndarray, int]:
    """RANSACRegressor(max_trials, residual_threshold, random_state=42)
    .fit(points[:, :2], points[:, 2]) -> (inlier_mask_, n_trials_).

    The subsets are drawn on the host exactly as scikit-learn draws them
    from RandomState(42); the trials are scored in chunks on the device
    (the plane of each subset, |residual| <= threshold over all points, the
    inlier count and R^2 on the inliers), and the host walks each chunk in
    order as scikit-learn's loop does: a trial with fewer inliers than the
    best is skipped, one with as many and a lower R^2 too, else it is the
    best and max_trials drops to _dynamic_max_trials at stop_probability
    0.99. The mask is the best trial's (not the refit's, _ransac.py:601)."""
    dev = _device(device)
    n = len(points)
    if RANSAC_MIN_SAMPLES > n:
        raise ValueError(f"`min_samples` may not be larger than number of samples: n_samples = {n}.")
    x = _f64(points[:, :2], dev)
    z = _f64(points[:, 2], dev)
    rng = np.random.RandomState(RANSAC_SEED)
    n_best, score_best, best, trials = 1, -np.inf, None, 0
    limit = max_trials
    chunks = iter(RANSAC_CHUNKS)
    while trials < limit:
        size = next(chunks, RANSAC_CHUNKS[-1])
        draws = np.stack([sample_without_replacement(n, RANSAC_MIN_SAMPLES, rng)
                          for _ in range(int(min(size, limit - trials)))])
        sub = torch.as_tensor(draws, device=dev)
        models = _plane_models(x[sub], z[sub])
        pred = x[:, 0] * models[:, :1] + x[:, 1] * models[:, 1:2] + models[:, 2:]
        resid = z[None, :] - pred
        inl = resid.abs() <= residual_threshold
        count = inl.sum(1)
        w = inl.double()
        mean_in = (w * z).sum(1) / count.clamp(min=1)
        ss_res = (w * resid * resid).sum(1)
        ss_tot = (w * (z[None, :] - mean_in[:, None]) ** 2).sum(1)
        r2 = torch.where(ss_tot != 0, 1 - ss_res / torch.where(ss_tot != 0, ss_tot, 1.0),
                         torch.where(ss_res == 0, 1.0, 0.0))
        count, r2 = count.cpu().numpy(), r2.cpu().numpy()
        for t in range(len(draws)):
            if not trials < limit:
                break
            trials += 1
            if count[t] < n_best or (count[t] == n_best and r2[t] < score_best):
                continue
            n_best, score_best, best = int(count[t]), float(r2[t]), models[t]
            limit = min(limit, dynamic_max_trials(n_best, n, RANSAC_MIN_SAMPLES,
                                                  RANSAC_STOP_PROBABILITY))
    if best is None:
        raise ValueError("RANSAC could not find a valid consensus set.")
    pred = x[:, 0] * best[0] + x[:, 1] * best[1] + best[2]
    return ((z - pred).abs() <= residual_threshold).cpu().numpy(), trials


def ransac_plane_fit(
    points: np.ndarray, max_trials: int = 2000, residual_threshold: float = 0.1,
    device="cuda",
) -> np.ndarray:
    """Keep RANSAC inliers of the plane z = f(x, y) (WL_iden.py:51-55)."""
    return points[ransac_inlier_mask(points, max_trials, residual_threshold, device)[0]]


def project_to_plane(points: np.ndarray) -> np.ndarray:
    return points[:, :2]


def detect_and_trim_edges(points: np.ndarray, percentile: float = 20) -> np.ndarray:
    """Density-histogram edge trim (WL_iden.py:65-79)."""
    x, y = points[:, 0], points[:, 1]
    x_density, x_bins = np.histogram(x, bins=100)
    y_density, y_bins = np.histogram(y, bins=100)
    x_threshold = np.percentile(x_density, percentile)
    y_threshold = np.percentile(y_density, percentile)
    x_idx = np.clip(np.digitize(x, x_bins[1:-1]) - 1, 0, len(x_density) - 1)
    y_idx = np.clip(np.digitize(y, y_bins[1:-1]) - 1, 0, len(y_density) - 1)
    x_mask = (x_density[x_idx] > x_threshold) & (x_density[x_idx] < x_density.max())
    y_mask = (y_density[y_idx] > y_threshold) & (y_density[y_idx] < y_density.max())
    return points[x_mask & y_mask]


def minimum_bounding_rectangle(points: np.ndarray) -> np.ndarray:
    """Rotating-calipers MBR over the convex hull (WL_iden.py:81-113).
    Returns the 4 rectangle corners [4, 2]."""
    hull_points = points[ConvexHull(points).vertices]
    edges = np.subtract.outer(hull_points, hull_points).reshape(-1, 2)
    angles = np.arctan2(edges[:, 1], edges[:, 0])
    angles = np.abs(np.mod(angles, np.pi / 2))
    angles = np.unique(angles)

    rotations = np.vstack(
        [np.cos(angles), -np.sin(angles), np.sin(angles), np.cos(angles)]
    ).T.reshape(-1, 2, 2)
    rot_points = np.dot(rotations, hull_points.T)

    min_x = np.nanmin(rot_points[:, 0], axis=1)
    max_x = np.nanmax(rot_points[:, 0], axis=1)
    min_y = np.nanmin(rot_points[:, 1], axis=1)
    max_y = np.nanmax(rot_points[:, 1], axis=1)
    areas = (max_x - min_x) * (max_y - min_y)
    best = int(np.argmin(areas))

    x1, x2 = max_x[best], min_x[best]
    y1, y2 = max_y[best], min_y[best]
    r = rotations[best]
    return np.array(
        [
            np.dot([x1, y2], r),
            np.dot([x2, y2], r),
            np.dot([x2, y1], r),
            np.dot([x1, y1], r),
        ]
    )


def adaptive_voxel_size(
    data: np.ndarray,
    target_points_ratio: float = 0.1,
    min_points: int = 1000,
    max_voxel_size: float = 0.5,
    min_voxel_size: float = 0.01,
    seed: int = 0,
) -> float:
    """Density + NN-distance initial estimate, bisection to a target point
    count (WL_iden.py:116-181)."""
    points = data[:, :3]
    rng = np.random.default_rng(seed)
    n = len(points)
    bbox = points.max(0) - points.min(0)
    point_density = n / max(np.prod(bbox), 1e-12)

    sample = points[rng.choice(n, min(1000, n), replace=False)]
    tree = cKDTree(sample)
    d, _ = tree.query(sample, k=2)
    mean_nn = float(np.mean(d[:, 1]))

    density_size = (1.0 / point_density) ** (1.0 / 3.0)
    voxel_size = float(np.mean([density_size, mean_nn * 2]))
    target = max(min_points, int(n * target_points_ratio))
    left, right = min_voxel_size, max_voxel_size
    for _ in range(10):
        coords = np.floor(points / voxel_size).astype(int)
        cur = len(np.unique(coords, axis=0))
        if abs(cur - target) / target < 0.1:
            break
        if cur > target:
            left = voxel_size
            voxel_size = (voxel_size + right) / 2
        else:
            right = voxel_size
            voxel_size = (left + voxel_size) / 2
    return float(np.clip(voxel_size, min_voxel_size, max_voxel_size))


def data_voxel(data: np.ndarray, voxel_size: Optional[float] = None) -> np.ndarray:
    """First-point-per-voxel downsampling (WL_iden.py:184-197). Native C++
    fast path when built; exact same selection (first point per voxel)."""
    if voxel_size is None:
        voxel_size = adaptive_voxel_size(data)
    pts = data[:, :3]
    try:
        from ..data import native

        if native.native_available():
            idx = native.voxel_first_indices(pts, float(voxel_size))
            # replicate np.unique's lexicographic voxel ordering exactly
            # (downstream RANSAC sampling is order-sensitive)
            c = np.floor(pts[idx] / voxel_size).astype(int)
            order = np.lexsort((c[:, 2], c[:, 1], c[:, 0]))
            return pts[idx[order]]
    except Exception:
        pass
    coords = np.floor(pts / voxel_size).astype(int)
    _, unique_idx = np.unique(coords, axis=0, return_index=True)
    return pts[unique_idx]


# ------------------------------------------------------- isolation forest

# scikit-learn's IsolationForest and its ExtraTreeRegressor defaults
FOREST_TREES = 100
FOREST_MAX_SAMPLES = 256
FOREST_SEED = 42
_INT32_MAX = np.iinfo(np.int32).max
_RAND_R_MAX = 2147483647
# tree/_partitioner.pxd: a node whose values span no more is constant
_FEATURE_THRESHOLD = np.float32(1e-7)


def average_path_length(n_samples_leaf) -> np.ndarray:
    """scikit-learn's _average_path_length (ensemble/_iforest.py:647): c(n),
    the mean depth of an unsuccessful search in a binary tree of n."""
    n_samples_leaf = np.asarray(n_samples_leaf)
    n_samples_leaf_shape = n_samples_leaf.shape
    n_samples_leaf = n_samples_leaf.reshape((1, -1))
    average_path_length = np.zeros(n_samples_leaf.shape)

    mask_1 = n_samples_leaf <= 1
    mask_2 = n_samples_leaf == 2
    not_mask = ~np.logical_or(mask_1, mask_2)

    average_path_length[mask_1] = 0.0
    average_path_length[mask_2] = 1.0
    average_path_length[not_mask] = (
        2.0 * (np.log(n_samples_leaf[not_mask] - 1.0) + np.euler_gamma)
        - 2.0 * (n_samples_leaf[not_mask] - 1.0) / n_samples_leaf[not_mask]
    )
    return average_path_length.reshape(n_samples_leaf_shape)


class IsolationTree(NamedTuple):
    """One tree in preorder: the threshold of each split node (left where
    the float32 value <= threshold), its children (-1 at a leaf), each
    node's samples and its depth + c(samples) - 1.0, what a point ending
    there adds to its depth sum."""
    threshold: np.ndarray
    left: np.ndarray
    right: np.ndarray
    count: np.ndarray
    value: np.ndarray


def _rand_r(state: int) -> Tuple[int, int]:
    """tree/_utils our_rand_r: a 32-bit xorshift -> (state, draw < 2^31)."""
    state = state or 1
    state ^= (state << 13) & 0xFFFFFFFF
    state ^= state >> 17
    state ^= (state << 5) & 0xFFFFFFFF
    return state, state % (_RAND_R_MAX + 1)


def build_isolation_tree(values: np.ndarray, max_depth: int, state: int) -> IsolationTree:
    """scikit-learn's ExtraTreeRegressor(max_features=1, splitter="random",
    max_depth) on one float32 feature, grown depth first, left child first,
    from the xorshift state its RandomSplitter seeds: at each node that may
    split, one draw picks the feature (the only one); a node whose float32
    values span no more than 1e-7 is a leaf, else a second draw gives the
    threshold, uniform in [min, max) (max -> min). Over one feature a node
    is a run of the sorted values. The regression targets scikit-learn draws
    decide nothing here: a node of two or more samples has positive
    impurity."""
    v32 = np.sort(values.astype(np.float32))
    v64 = v32.astype(np.float64)
    thr, left, right, count, depth = [], [], [], [], []

    def grow(lo: int, hi: int, level: int) -> int:
        nonlocal state
        node = len(thr)
        thr.append(-2.0)
        left.append(-1)
        right.append(-1)
        count.append(hi - lo)
        depth.append(level + 1)
        if level >= max_depth or hi - lo < 2:
            return node
        state, _ = _rand_r(state)
        low, high = v32[lo], v32[hi - 1]
        if high <= np.float32(low + _FEATURE_THRESHOLD):
            return node
        state, draw = _rand_r(state)
        cut = (float(high) - float(low)) * float(draw) / float(_RAND_R_MAX) + float(low)
        if cut == float(high):
            cut = float(low)
        pos = lo + int(np.searchsorted(v64[lo:hi], cut, side="right"))
        thr[node] = cut
        left[node] = grow(lo, pos, level + 1)
        right[node] = grow(pos, hi, level + 1)
        return node

    grow(0, len(v32), 0)
    count = np.asarray(count, np.int64)
    value = (np.asarray(depth, np.int64) + average_path_length(count)) - 1.0
    return IsolationTree(np.asarray(thr), np.asarray(left), np.asarray(right), count, value)


def isolation_forest_trees(feature: np.ndarray) -> Tuple[List[IsolationTree], int]:
    """The trees of IsolationForest(random_state=42).fit on one feature ->
    (trees, max_samples): seeds RandomState(42).randint(2^31 - 1, size=100)
    (bagging), a tree's subsample sample_without_replacement(n,
    min(256, n)) from RandomState(seed) and its splitter's xorshift state
    RandomState(RandomState(seed).randint(2^31 - 1)).randint(0, 2^31 - 1);
    depth ceil(log2(max_samples)) (_iforest.py:356)."""
    n = len(feature)
    max_samples = min(FOREST_MAX_SAMPLES, n)
    max_depth = int(np.ceil(np.log2(max(max_samples, 2))))
    seeds = np.random.RandomState(FOREST_SEED).randint(_INT32_MAX, size=FOREST_TREES)
    trees = []
    for seed in seeds:
        tree_seed = np.random.RandomState(seed).randint(_INT32_MAX)
        state = int(np.random.RandomState(tree_seed).randint(0, _RAND_R_MAX))
        bag = np.random.RandomState(seed)
        sample_without_replacement(1, 1, bag)  # the feature draw
        rows = sample_without_replacement(n, max_samples, bag)
        trees.append(build_isolation_tree(feature[np.sort(rows)], max_depth, state))
    return trees, max_samples


def isolation_forest_inliers(feature: np.ndarray, contamination: float, device="cuda") -> np.ndarray:
    """IsolationForest(contamination, random_state=42).fit_predict(feature[:,
    None]) == 1: the trees built on the host, every point scored on the
    device (each tree walked level by level on the float32 feature, the
    depth sum added tree by tree in order, 2^(-sum / (trees c(max_samples)))),
    offset_ at the contamination percentile of -score (_iforest.py:388),
    inliers where -score >= offset_."""
    dev = _device(device)
    trees, max_samples = isolation_forest_trees(feature)
    width = max(len(t.threshold) for t in trees)

    def table(field, fill, dtype):
        out = np.full((len(trees), width), fill, dtype)
        for i, t in enumerate(trees):
            out[i, :len(t.threshold)] = getattr(t, field)
        return torch.as_tensor(out, device=dev)

    thr = table("threshold", -2.0, np.float64)
    left, right = table("left", -1, np.int64), table("right", -1, np.int64)
    value = table("value", 0.0, np.float64)
    x = torch.as_tensor(feature.astype(np.float32), device=dev).double()
    node = torch.zeros(len(trees), len(x), dtype=torch.int64, device=dev)
    for _ in range(int(np.ceil(np.log2(max(max_samples, 2))))):
        go = torch.where(x[None, :] <= thr.gather(1, node), left.gather(1, node),
                         right.gather(1, node))
        node = torch.where(go >= 0, go, node)
    per_tree = value.gather(1, node)
    depths = torch.zeros(len(x), dtype=torch.float64, device=dev)
    for t in range(len(trees)):
        depths += per_tree[t]
    denominator = len(trees) * average_path_length([max_samples])[0]
    if denominator != 0:
        scores = -torch.pow(2.0, -(depths / denominator))
    else:
        scores = torch.full_like(depths, -0.5)
    offset = np_percentile(scores, 100.0 * contamination)
    return (scores - offset >= 0).cpu().numpy()


def isolation_forest_outlier_removal(
    points: np.ndarray, contamination: float = 0.1, device="cuda"
) -> np.ndarray:
    """Directional IsolationForest: relaxed along the bridge-length axis,
    strict along width; keep points normal in both (WL_iden.py:200-230)."""
    t_l, i_l, c_l, _ = directional_outlier_detection(points, contamination, True, device)
    t_w, i_w, c_w, _ = directional_outlier_detection(points, contamination, False, device)
    lab_l = isolation_forest_inliers(t_l[:, i_l], c_l, device)
    lab_w = isolation_forest_inliers(t_w[:, i_w], c_w, device)
    return points[lab_l & lab_w]


# ------------------------------------------------------------------ LOF


def adaptive_lof_params(
    points: np.ndarray,
    target_precision: float = 0.03,
    min_neighbors: int = 5,
    max_neighbors: int = 50,
    seed: int = 0,
    device="cuda",
) -> Tuple[int, float]:
    """Density/variance-driven LOF parameter selection (WL_iden.py:260-327):
    NearestNeighbors(n_neighbors=k + 1).kneighbors() over a sample of 1000,
    the k + 1 nearest of each without itself, through K5."""
    dev = _device(device)
    rng = np.random.default_rng(seed)
    n = len(points)
    bbox = points.max(0) - points.min(0)
    volume = max(np.prod(bbox), 1e-12)
    density = n / volume
    expected = density * (4.0 / 3.0 * np.pi * target_precision**3)

    sample = points[rng.choice(n, min(1000, n), replace=False)]
    k = min(20, len(sample) - 1)
    x = _f64(sample, dev)
    xc = _centred32(x)
    _, idx = knn_picks(xc, xc, k + 2)
    d = _distances(x, x, _drop_self(idx)).sort(1).values
    mean_dist = d[:, 1:].mean(1)
    std_dist = d[:, 1:].std(1, unbiased=False)
    cv = std_dist / mean_dist.clamp(min=1e-12)
    n_neighbors = int(np.clip(int(expected) * (1 + float(cv.mean())), min_neighbors, max_neighbors))
    threshold = mean_dist.mean() + 2 * mean_dist.std(unbiased=False)
    contamination = float(np.clip(float((mean_dist > threshold).double().mean()), 0.01, 0.1))
    return n_neighbors, contamination


def lof_negative_outlier_factor(points: np.ndarray, n_neighbors: int, device="cuda") -> torch.Tensor:
    """LocalOutlierFactor(n_neighbors).fit(points).negative_outlier_factor_:
    K5's k + 1 nearest of each point (k = min(n_neighbors, n - 1)), the
    point dropped, their distances in float64, the k-distance of each point
    (its farthest pick), reach distances max(d, k-distance of the pick),
    lrd = 1 / (mean reach + 1e-10), nof = -mean(lrd[pick] / lrd)."""
    dev = _device(device)
    n = len(points)
    k = max(1, min(n_neighbors, n - 1))
    if dev.type == "cuda" and k + 1 > KNN_MAX_K:
        raise ValueError(f"LOF with n_neighbors={n_neighbors} needs {k + 1} neighbours a point; "
                         f"the k-NN kernel takes at most {KNN_MAX_K}")
    x = _f64(points, dev)
    xc = _centred32(x)
    _, idx = knn_picks(xc, xc, k + 1)
    idx = _drop_self(idx)
    dist = _distances(x, x, idx)
    dist_k = dist.max(1).values
    reach = torch.maximum(dist, dist_k[idx])
    lrd = 1.0 / (reach.mean(1) + 1e-10)
    return -(lrd[idx] / lrd[:, None]).mean(1)


def lof_outlier_removal(
    points: np.ndarray,
    n_neighbors: Optional[int] = None,
    contamination: Optional[float] = None,
    device="cuda",
) -> np.ndarray:
    """LocalOutlierFactor(n_neighbors, contamination).fit_predict(points) == 1:
    outliers where nof < offset_, the contamination percentile of nof."""
    if n_neighbors is None or contamination is None:
        n_neighbors, contamination = adaptive_lof_params(points, device=device)
    nof = lof_negative_outlier_factor(points, n_neighbors, device)
    offset = np_percentile(nof, 100.0 * contamination)
    return points[~(nof < offset).cpu().numpy()]


def dbscan_inliers(points: np.ndarray, eps: float = 0.5, min_samples: int = 5,
                   device="cuda") -> np.ndarray:
    """DBSCAN(eps, min_samples).fit_predict(StandardScaler().fit_transform(
    points)) != -1, without the labels: on the standardised points
    (population std, a zero std taken as 1) a point is core where its
    min_samples-th neighbour, itself counted, lies within eps; noise where
    it is not core and its nearest core point (K5, k = 1 over the core
    points) lies farther than eps."""
    dev = _device(device)
    x = _f64(points, dev)
    std = x.std(0, unbiased=False)
    scaled = (x - x.mean(0)) / torch.where(std == 0, 1.0, std)
    s32 = scaled.float().contiguous()
    n = len(points)
    if n < min_samples:
        return np.zeros(n, bool)
    _, idx = knn_picks(s32, s32, min_samples)
    core = _distances(scaled, scaled, idx).max(1).values <= eps
    keep = core.clone()
    rest = (~core).nonzero()[:, 0]
    if core.any() and len(rest):
        cores = core.nonzero()[:, 0]
        _, near = knn_picks(s32[cores].contiguous(), s32[rest].contiguous(), 1)
        keep[rest] = _distances(scaled[cores], scaled[rest], near)[:, 0] <= eps
    return keep.cpu().numpy()


def dbscan_outlier_removal(
    points: np.ndarray, eps: float = 0.5, min_samples: int = 5, device="cuda"
) -> np.ndarray:
    return points[dbscan_inliers(points, eps, min_samples, device)]


def calculate_dimensions(
    points: np.ndarray, rect: np.ndarray
) -> Tuple[float, float]:
    """Edge-point-projection refinement clipped to ±5% of the MBR sides
    (WL_iden.py:492-555). Returns (length, width) along rect edges."""
    original_width = float(np.linalg.norm(rect[1] - rect[0]))
    original_length = float(np.linalg.norm(rect[2] - rect[1]))
    dir1 = (rect[1] - rect[0]) / original_width
    dir2 = (rect[2] - rect[1]) / original_length

    margin = 0.1
    proj1 = np.dot(points - rect[0], dir1)
    proj2 = np.dot(points - rect[1], dir2)
    edge_w = points[
        (proj1 < margin * original_width) | (proj1 > (1 - margin) * original_width)
    ]
    edge_l = points[
        (proj2 < margin * original_length) | (proj2 > (1 - margin) * original_length)
    ]
    if len(edge_w) > 0 and len(edge_l) > 0:
        wp = np.dot(edge_w - rect[0], dir1)
        lp = np.dot(edge_l - rect[1], dir2)
        width = float(
            np.clip(wp.max() - wp.min(), 0.95 * original_width, 1.05 * original_width)
        )
        length = float(
            np.clip(lp.max() - lp.min(), 0.95 * original_length, 1.05 * original_length)
        )
    else:
        width, length = original_width, original_length
    return length, width


def process_bridge_deck(
    points: np.ndarray,
    voxel_size: float = 0.02,
    ransac_max_trials: int = 1000,
    ransac_residual_threshold: float = 0.3,
    isolation_forest_contamination: float = 0.3,
    lof_n_neighbors: int = 30,
    lof_contamination: float = 0.4,
    dbscan_eps: float = 1.0,
    dbscan_min_samples: int = 5,
    percentile: float = 20,
    device="cuda",
) -> Tuple[float, float, np.ndarray, np.ndarray]:
    """Full denoise + measure chain on PREDICTED deck points
    (WL_iden.py:365-430). Returns (length, width, trimmed_points, rect) with
    length >= width."""
    result = points[:, :3]
    result = data_voxel(result, voxel_size=voxel_size)
    result = ransac_plane_fit(result, ransac_max_trials, ransac_residual_threshold, device)
    result = isolation_forest_outlier_removal(result, isolation_forest_contamination, device)
    result = lof_outlier_removal(result, lof_n_neighbors, lof_contamination, device)
    result = project_to_plane(result)
    points_trimmed = detect_and_trim_edges(result, percentile)
    result = detect_and_trim_edges(result)
    rect = minimum_bounding_rectangle(result)
    length, width = calculate_dimensions(result, rect)
    return max(width, length), min(width, length), points_trimmed, rect


def process_raw(
    points: np.ndarray, percentile: float = 20, device="cuda"
) -> Tuple[float, float, np.ndarray, np.ndarray]:
    """Ground-truth branch: no denoising (WL_iden.py:434-463)."""
    xy = project_to_plane(points[:, :3])
    result = align_to_principal_axes(xy, device)
    points_trimmed = detect_and_trim_edges(result, percentile)
    result = detect_and_trim_edges(result)
    rect = minimum_bounding_rectangle(result)
    length, width = calculate_dimensions(result, rect)
    return max(width, length), min(width, length), points_trimmed, rect


def evaluate_result(
    length_raw: float, width_raw: float, length_pred: float, width_pred: float
) -> float:
    """Mean relative error over both dimensions (WL_iden.py:466-469)."""
    le = abs(length_raw - length_pred) / length_raw
    we = abs(width_raw - width_pred) / width_raw
    return (le + we) / 2


def save_overlay_figure(
    points_trimmed: np.ndarray,
    rect: np.ndarray,
    out_path: str,
    title: str = "",
) -> str:
    """Trimmed points + fitted minimum bounding rectangle overlay
    (WL_iden.py:633-672 / WL_iden_vision.py figures)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 6))
    ax.scatter(points_trimmed[:, 0], points_trimmed[:, 1], s=2, alpha=0.5,
               label="trimmed deck points")
    closed = np.vstack([rect, rect[:1]])
    ax.plot(closed[:, 0], closed[:, 1], "r-", lw=2, label="min bounding rect")
    ax.set_aspect("equal")
    ax.legend()
    ax.set_title(title)
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    fig.savefig(out_path, dpi=200)
    plt.close(fig)
    return out_path


def default_hyperparams() -> Dict:
    """The chain's hyperparameters as WL_iden.py's __main__ sets them."""
    return dict(
        voxel_size=0.02,
        ransac_max_trials=1000,
        ransac_residual_threshold=0.3,
        isolation_forest_contamination=0.3,
        lof_n_neighbors=30,
        lof_contamination=0.4,
        percentile=20,
    )


def run_wl_identification(
    cases: Iterable[Tuple[str, np.ndarray, np.ndarray]],
    out_csv: Optional[str] = None,
    hyperparams: Optional[Dict] = None,
    fig_dir: Optional[str] = None,
    device="cuda",
) -> List[Dict]:
    """Batch driver mirroring WL_iden.py __main__ (:559-676).

    Args:
      cases: iterable of (name, raw_points [N,>=3], pred_points [M,>=3]) —
        points already filtered to the target class.
      out_csv: append results (hyperparams + per-case rows + mean error).
      device: where the PyTorch stages run ("cuda", the default, or "cpu").
    Returns the per-case result rows.
    """
    hp = default_hyperparams()
    if hyperparams:
        hp.update(hyperparams)

    rows: List[Dict] = []
    for name, raw_pts, pred_pts in cases:
        t0 = time.time()
        l_raw, w_raw, _, _ = process_raw(raw_pts, percentile=hp["percentile"], device=device)
        l_pred, w_pred, trimmed, rect = process_bridge_deck(
            pred_pts,
            voxel_size=hp["voxel_size"],
            ransac_max_trials=hp["ransac_max_trials"],
            ransac_residual_threshold=hp["ransac_residual_threshold"],
            isolation_forest_contamination=hp["isolation_forest_contamination"],
            lof_n_neighbors=hp["lof_n_neighbors"],
            lof_contamination=hp["lof_contamination"],
            percentile=hp["percentile"],
            device=device,
        )
        err = evaluate_result(l_raw, w_raw, l_pred, w_pred)
        if fig_dir:
            try:
                save_overlay_figure(
                    trimmed, rect, os.path.join(fig_dir, f"{name}_overlay.png"),
                    title=f"{name}: {max(l_pred, w_pred):.2f} x "
                          f"{min(l_pred, w_pred):.2f} m (err {err:.3f})",
                )
            except Exception:
                pass
        rows.append(
            {
                "name": name,
                "length_raw": l_raw,
                "width_raw": w_raw,
                "length_pred": l_pred,
                "width_pred": w_pred,
                "relative_error": err,
                "time_s": time.time() - t0,
                **hp,
            }
        )

    if out_csv and rows:
        exists = os.path.exists(out_csv)
        with open(out_csv, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            if not exists:
                w.writeheader()
            w.writerows(rows)
    return rows
