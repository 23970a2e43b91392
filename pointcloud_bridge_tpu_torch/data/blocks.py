"""Block samplers (L1 in SURVEY.md §2.4) — fixed-shape [num_points] blocks.

Exact contracts reproduced from the reference:
  - normalize_points: centroid-center + divide by max radius
    (utils/BriPCDMulti.py:91-102).
  - points_in_block: xy box + z within ±z_threshold of box center — the
    reference's numba kernel (BriPCDMulti.py:179-189), vectorized numpy here
    (a C++ native path can slot in; numpy is already ~memory-bound).
  - stratified_sample_indices: >= min_ratio of the block per present class,
    remainder by the original distribution (BriPCDMulti.py:202-255).
  - weighted_stratified_sample_indices: sample toward target class
    proportions, rare classes boosted 1.3x / common damped 0.9x
    (BriPCD_gen.py:185-273).
  - make_training_blocks: per sampling iteration one stratified GLOBAL block
    + one LOCAL block around a random center (block_size x block_size x ±2 m)
    (BriPCDMulti.py:257-324).
  - s3dis_column_block: LWBridgeDataset's random 1 m column with retry and
    9-channel output [x_c, y_c, z, r, g, b, x/ext, y/ext, z/ext]
    (BridgeDataLoader.py:104-166).
  - whole_scene_grid_blocks: ScannetDatasetWholeScene's deterministic sliding
    grid (stride*block_size), pad-to-multiple-of-block_points, 9-channel +
    labelweights + original indices (BridgeDataLoader.py:214-277).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np


def normalize_points(points: np.ndarray) -> np.ndarray:
    """Centroid-center then scale by the max radius (BriPCDMulti.py:91-102)."""
    points = points - points.mean(axis=0, keepdims=True)
    max_dist = np.sqrt((points**2).sum(axis=1)).max()
    if max_dist > 0:
        points = points / max_dist
    return points


def points_in_block(
    points: np.ndarray,
    block_min: np.ndarray,
    block_max: np.ndarray,
    z_threshold: float = 2.0,
) -> np.ndarray:
    """Indices of points inside the xy box and within ±z_threshold of the
    box z-center (BriPCDMulti.py:179-189). Uses the native C++ kernel when
    built (data/native.py), numpy otherwise."""
    from . import native

    if native.native_available():
        mask = native.points_in_block_mask(
            points, np.asarray(block_min, np.float64),
            np.asarray(block_max, np.float64), z_threshold,
        )
        return np.where(mask)[0]
    z_center = (block_min[2] + block_max[2]) / 2.0
    mask = (
        (points[:, 0] >= block_min[0])
        & (points[:, 0] <= block_max[0])
        & (points[:, 1] >= block_min[1])
        & (points[:, 1] <= block_max[1])
        & (np.abs(points[:, 2] - z_center) <= z_threshold)
    )
    return np.where(mask)[0]


def stratified_sample_indices(
    labels: np.ndarray,
    num_points: int,
    num_classes: int,
    min_ratio: float = 0.05,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Stratified sampling: every present class gets >= min_ratio * num_points
    (or all its points), remainder follows the data distribution
    (BriPCDMulti.py:202-255)."""
    rng = rng or np.random.default_rng()
    all_indices = np.arange(len(labels))
    selected: List[np.ndarray] = []
    min_per_class = int(num_points * min_ratio)
    remaining = num_points
    for class_id in range(num_classes):
        class_idx = all_indices[labels == class_id]
        if len(class_idx) == 0:
            continue
        if len(class_idx) <= min_per_class:
            selected.append(class_idx)
            remaining -= len(class_idx)
        else:
            sel = rng.choice(class_idx, min_per_class, replace=False)
            selected.append(sel)
            remaining -= min_per_class
    chosen = np.concatenate(selected) if selected else np.empty(0, np.int64)
    if remaining > 0:
        mask = np.ones(len(labels), bool)
        mask[chosen] = False
        pool = all_indices[mask]
        if len(pool) > 0:
            extra = rng.choice(pool, min(remaining, len(pool)), replace=False)
            chosen = np.concatenate([chosen, extra])
    # pad by resampling if the scene is smaller than num_points
    if len(chosen) < num_points:
        pad = rng.choice(chosen, num_points - len(chosen), replace=True)
        chosen = np.concatenate([chosen, pad])
    rng.shuffle(chosen)
    return chosen.astype(np.int64)


def weighted_stratified_sample_indices(
    labels: np.ndarray,
    num_points: int,
    proportions: Dict[int, float],
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Sample so class c contributes ~proportions[c] of the block, with
    replacement when a class is too small (BriPCD_gen.py:185-234)."""
    rng = rng or np.random.default_rng()
    classes = np.unique(labels)
    total = sum(proportions.values())
    norm = {k: v / total for k, v in proportions.items()}
    desired = {int(c): int(norm.get(int(c), 0.0) * num_points) for c in classes}
    diff = num_points - sum(desired.values())
    if diff != 0 and desired:
        max_cls = max(desired, key=desired.get)
        desired[max_cls] += diff
    selected: List[np.ndarray] = []
    for c in classes:
        n = desired.get(int(c), 0)
        if n <= 0:
            continue
        pool = np.where(labels == c)[0]
        if len(pool) == 0:
            continue
        selected.append(rng.choice(pool, n, replace=len(pool) < n))
    out = np.concatenate(selected) if selected else np.empty(0, np.int64)
    rng.shuffle(out)
    return out.astype(np.int64)


def boosted_class_proportions(
    labels: np.ndarray, boost_factor: float = 1.3
) -> Dict[int, float]:
    """Rare classes boosted (capped at 1.5x average), common damped 0.9x,
    renormalized (BriPCD_gen.py:246-273)."""
    classes, counts = np.unique(labels, return_counts=True)
    total = counts.sum()
    orig = {int(c): n / total for c, n in zip(classes, counts)}
    avg = 1.0 / len(classes)
    desired = {}
    for c, p in orig.items():
        if p < avg:
            desired[c] = min(p * boost_factor, avg * 1.5)
        else:
            desired[c] = p * 0.9
    s = sum(desired.values())
    return {c: p / s for c, p in desired.items()}


@dataclass
class Block:
    """One training block — the reference dataset item contract
    (BriPCDMulti.py:344-365)."""

    points: np.ndarray  # [P, 3] normalized (whole-scene normalization)
    colors: np.ndarray  # [P, 3] in [0, 1]
    labels: np.ndarray  # [P] int
    original_points: np.ndarray  # [P, 3] raw coordinates
    indices: np.ndarray  # [P] indices into the source scene
    file_name: str = ""


def make_training_blocks(
    points: np.ndarray,
    colors: np.ndarray,
    labels: np.ndarray,
    num_points: int = 4096,
    block_size: float = 1.0,
    sample_rate: float = 0.5,
    num_classes: Optional[int] = None,
    weighted: bool = False,
    stratified: bool = True,
    file_name: str = "",
    seed: int = 0,
    z_threshold: float = 2.0,
) -> List[Block]:
    """Global + local box blocks. Global sampling modes:
      - stratified=True, weighted=False: >=5% per class (BriPCDMulti.py:257-324)
      - weighted=True: boosted class proportions (BriPCD_gen.py)
      - stratified=False: plain uniform random (BriPCDMulti_voxel.py:150-236)
    """
    rng = np.random.default_rng(seed)
    n = len(points)
    iters = max(1, int(n * sample_rate / num_points))
    normal_points = normalize_points(points.astype(np.float64)).astype(np.float32)
    if num_classes is None:
        num_classes = int(labels.max()) + 1
    proportions = boosted_class_proportions(labels) if weighted else None

    blocks: List[Block] = []
    local_blocks: List[Block] = []
    for _ in range(iters):
        if weighted:
            idx = weighted_stratified_sample_indices(
                labels, num_points, proportions, rng
            )
        elif stratified:
            idx = stratified_sample_indices(labels, num_points, num_classes, 0.05, rng)
        else:
            idx = rng.choice(n, num_points, replace=n < num_points)
            idx = idx.astype(np.int64)
        blocks.append(
            Block(
                points=normal_points[idx],
                colors=colors[idx].astype(np.float32),
                labels=labels[idx].astype(np.int64),
                original_points=points[idx].astype(np.float32),
                indices=idx,
                file_name=file_name,
            )
        )
        # local block around a random center
        center = points[rng.integers(n)][:3]
        bmin = center - np.array([block_size / 2, block_size / 2, 0.0])
        bmax = center + np.array([block_size / 2, block_size / 2, 0.0])
        in_block = points_in_block(points, bmin, bmax, z_threshold)
        if len(in_block) >= num_points:
            sel = rng.choice(in_block, num_points, replace=False)
            local_blocks.append(
                Block(
                    points=normal_points[sel],
                    colors=colors[sel].astype(np.float32),
                    labels=labels[sel].astype(np.int64),
                    original_points=points[sel].astype(np.float32),
                    indices=sel,
                    file_name=file_name,
                )
            )
    return blocks + local_blocks


def s3dis_column_block(
    points6: np.ndarray,
    labels: np.ndarray,
    coord_min: np.ndarray,
    coord_max: np.ndarray,
    num_point: int = 4096,
    block_size: float = 1.0,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """LWBridgeDataset random-column sampler (BridgeDataLoader.py:104-166).

    Returns (points9 [num_point, 9], labels [num_point]). Channels:
    [x-center_x, y-center_y, z, r, g, b, x/ext_x, y/ext_y, z/ext_z].
    """
    rng = rng or np.random.default_rng()
    n = len(points6)
    point_idxs = np.empty(0, np.int64)
    for attempt in range(101):
        center = points6[rng.integers(n)][:3]
        bmin = center - np.array([block_size / 2, block_size / 2, 0.0])
        bmax = center + np.array([block_size / 2, block_size / 2, 0.0])
        point_idxs = np.where(
            (points6[:, 0] >= bmin[0])
            & (points6[:, 0] <= bmax[0])
            & (points6[:, 1] >= bmin[1])
            & (points6[:, 1] <= bmax[1])
        )[0]
        if point_idxs.size > 1024:
            break
    if point_idxs.size == 0:  # degenerate scene; sample anywhere
        point_idxs = np.arange(n)
    replace = point_idxs.size < num_point
    sel = rng.choice(point_idxs, num_point, replace=replace)
    selected = points6[sel].copy()
    ext = coord_max - coord_min
    out = np.zeros((num_point, 9), np.float32)
    out[:, 6] = selected[:, 0] / max(ext[0], 1e-9)
    out[:, 7] = selected[:, 1] / max(ext[1], 1e-9)
    out[:, 8] = selected[:, 2] / max(ext[2], 1e-9)
    selected[:, 0] -= center[0]
    selected[:, 1] -= center[1]
    out[:, :6] = selected
    return out, labels[sel].astype(np.int64)


def _axis_windows(cmin, cmax, gcount, block_size, stride, padding):
    """Per-cell [lo, hi] membership thresholds along one axis, computed with
    the EXACT scalar expression sequence of the reference's per-cell loop
    (BridgeDataLoader.py:214-277) so vectorized binning is bit-identical to
    the naive per-cell np.where scans. Both arrays are non-decreasing
    (i*stride is monotone under rounding; min/sub by constants preserve it),
    which _grid_cell_members' searchsorted relies on."""
    lo = np.empty(gcount, np.float64)
    hi = np.empty(gcount, np.float64)
    for i in range(gcount):
        s = cmin + i * stride
        e = min(s + block_size, cmax)
        s = e - block_size
        lo[i] = s - padding
        hi[i] = e + padding
    return lo, hi


def _grid_cell_members(
    points6, coord_min, coord_max, grid_x, grid_y, block_size, stride, padding
):
    """Yield (cell_id, point_indices) for every nonempty sliding-grid cell in
    ascending cell order (iy-major), with indices ascending — exactly what
    per-cell `np.where(x-in-window & y-in-window)` scans produce, but in
    O(N·cover + P log P) instead of O(grid_x·grid_y·N): each point's covering
    cell range per axis is found by binary search on the window-threshold
    arrays (a point can only fall in a contiguous run of windows), the
    (cell, point) pairs are materialized once, and a single stable sort
    groups them by cell. 5M points / 2k cells: ~194 s -> ~2 s host time."""
    n = len(points6)
    x = points6[:, 0].astype(np.float64)
    y = points6[:, 1].astype(np.float64)
    lox_t, hix_t = _axis_windows(
        coord_min[0], coord_max[0], grid_x, block_size, stride, padding
    )
    loy_t, hiy_t = _axis_windows(
        coord_min[1], coord_max[1], grid_y, block_size, stride, padding
    )
    import os

    from . import native

    if (
        os.environ.get("PCB_NATIVE_GRID", "1") != "0"
        and native.native_available()
    ):
        # C++ counting sort (native/preproc.cpp::grid_ranges/grid_scatter):
        # same searchsorted semantics, but the 13M-pair expansion + stable
        # argsort become two passes with no comparison sort and no int
        # temporaries — equality vs this numpy path is tested directly.
        res = native.grid_cell_members(x, y, lox_t, hix_t, loy_t, hiy_t)
        if res is not None:
            offsets, pids = res
            for c in np.flatnonzero(np.diff(offsets)):
                yield int(c), pids[offsets[c] : offsets[c + 1]]
            return
    # x >= lo[i]  <=>  i < searchsorted(lo, x, 'right')
    # x <= hi[i]  <=>  i >= searchsorted(hi, x, 'left')
    # int32 throughout: fresh pages are costly to touch (~100us per 4K page
    # was measured), so pair-array bytes are the real cost at multi-M points.
    ix_lo = np.searchsorted(hix_t, x, side="left").astype(np.int32)
    ix_hi = (np.searchsorted(lox_t, x, side="right") - 1).astype(np.int32)
    iy_lo = np.searchsorted(hiy_t, y, side="left").astype(np.int32)
    iy_hi = (np.searchsorted(loy_t, y, side="right") - 1).astype(np.int32)
    del x, y
    cx = np.maximum(ix_hi - ix_lo + 1, 0)
    cy = np.maximum(iy_hi - iy_lo + 1, 0)
    cnt = (cx * cy).astype(np.int64)
    total = int(cnt.sum())
    if total == 0:
        return
    # int32 throughout the 13M-pair expansion (total and cell ids both fit):
    # every int64 temporary here is ~100 MB of extra page-faulted writes on
    # this host. Only fall back to int64 when the pair count or the cell-id
    # range genuinely overflows.
    i32 = total < 2**31 - 1 and grid_x * grid_y < 2**31 - 1
    idt = np.int32 if i32 else np.int64
    pt = np.repeat(np.arange(n, dtype=np.int32), cnt)
    starts = (np.cumsum(cnt) - cnt).astype(idt)
    off = np.arange(total, dtype=idt)
    off -= np.repeat(starts, cnt)
    off = off.astype(np.int32, copy=False)
    del starts
    cxr = cx[pt]
    jx = ix_lo[pt]
    jx += off % cxr
    jy = iy_lo[pt]
    jy += off // cxr
    del off, cxr, ix_lo, ix_hi, iy_lo, iy_hi, cx, cy
    cell = jy.astype(idt)
    cell *= grid_x
    cell += jx
    del jx, jy
    # pairs are already point-ascending; a stable single-key sort on cell
    # keeps them ascending within each cell (matches np.where order)
    order = np.argsort(cell, kind="stable")
    cell_s = cell[order]
    pt_s = pt[order]  # int32 point ids: every consumer is value-based
    del pt, cell, order
    # group boundaries: cell_s is sorted, so run breaks mark the cells
    breaks = np.flatnonzero(cell_s[1:] != cell_s[:-1]) + 1
    bounds = np.empty(len(breaks) + 2, np.int64)
    bounds[0], bounds[-1] = 0, total
    bounds[1:-1] = breaks
    for k in range(len(bounds) - 1):
        b = bounds[k]
        yield int(cell_s[b]), pt_s[b : bounds[k + 1]]


def precompute_grid_cells(
    points6: np.ndarray,
    block_size: float,
    stride: float,
    padding: float = 0.001,
):
    """Materialize the (seed-independent) sliding-grid cell membership.

    The expensive half of whole-scene gridding — window binning, pair
    expansion, stable grouping (~19 of 20.5 s per 5M-point pass) — depends
    only on the geometry, not on the vote seed. K-vote inference computes it
    once and passes the handle to every per-vote grid call, leaving only the
    per-vote rng pad-resampling + shuffle (bit-identical results either way).

    Returns an opaque handle for the `cells=` argument of
    whole_scene_grid_blocks / whole_scene_grid_indices.
    """
    points6 = np.ascontiguousarray(points6, dtype=np.float32)
    coord_min = points6[:, :3].min(axis=0)
    coord_max = points6[:, :3].max(axis=0)
    grid_x = int(np.ceil((coord_max[0] - coord_min[0] - block_size) / stride) + 1)
    grid_y = int(np.ceil((coord_max[1] - coord_min[1] - block_size) / stride) + 1)
    grid_x, grid_y = max(grid_x, 1), max(grid_y, 1)
    members = list(
        _grid_cell_members(
            points6, coord_min, coord_max, grid_x, grid_y, block_size,
            stride, padding,
        )
    )
    return {
        "members": members,
        "points6": points6,
        "coord_min": coord_min,
        "coord_max": coord_max,
        "grid_x": grid_x,
        "key": (block_size, stride, padding, points6.shape),
    }


def _grid_block_pids(
    points6: np.ndarray,
    block_points: int,
    block_size: float,
    stride: float,
    padding: float,
    seed: int,
    cells=None,
):
    """Shared cell -> shuffled-point-id selection for the whole-scene grid.

    Returns (blocks, points6_f32, coord_min, coord_max) where blocks is a
    list of (pid [target], cx, cy): pid is the pad-resampled, shuffled member
    list of one grid cell (target a multiple of block_points) and (cx, cy)
    the cell's XY block center as np.float32 — the exact scalar the data
    path subtracts when center_xy. The rng call sequence (one choice + one
    shuffle per nonempty cell, ascending cell order) is the contract that
    keeps whole_scene_grid_blocks and whole_scene_grid_indices bit-identical
    at the same seed. `cells` (precompute_grid_cells) skips the
    seed-independent membership pass.
    """
    rng = np.random.default_rng(seed)
    if cells is None:
        cells = precompute_grid_cells(points6, block_size, stride, padding)
    else:
        expect = (block_size, stride, padding, np.shape(points6))
        if cells["key"] != expect:
            raise ValueError(
                f"precomputed grid cells were built for {cells['key']}, "
                f"called with {expect}"
            )
    points6 = cells["points6"]
    coord_min = cells["coord_min"]
    coord_max = cells["coord_max"]
    grid_x = cells["grid_x"]

    blocks = []
    for cell_id, pid in cells["members"]:
        target = int(np.ceil(pid.size / block_points)) * block_points
        iy, ix = divmod(cell_id, grid_x)
        s_x = coord_min[0] + ix * stride
        e_x = min(s_x + block_size, coord_max[0])
        s_x = e_x - block_size
        s_y = coord_min[1] + iy * stride
        e_y = min(s_y + block_size, coord_max[1])
        s_y = e_y - block_size
        replace = (target - pid.size) > pid.size
        extra = rng.choice(pid, target - pid.size, replace=replace)
        pid = np.concatenate([pid, extra])
        rng.shuffle(pid)
        blocks.append(
            (
                pid,
                np.float32(s_x + block_size / 2.0),
                np.float32(s_y + block_size / 2.0),
            )
        )
    return blocks, points6, coord_min, coord_max


def scene_feature_table(points6: np.ndarray) -> np.ndarray:
    """Per-point 9-channel feature table [N, 9] = [xyz | rgb | xyz/extent].

    Row i gathered at index pid equals whole_scene_grid_blocks' UNcentered
    block row for point pid bit-for-bit (same f32 divide by the same f32
    extent scalars); block XY-centering is a per-block affine applied after
    gathering. This is the device-resident half of the index-streaming vote
    path (infer/vote.py device_gather): the table crosses the link once,
    per-vote traffic is int32 indices only.
    """
    points6 = np.ascontiguousarray(points6, dtype=np.float32)
    coord_min = points6[:, :3].min(axis=0)
    coord_max = points6[:, :3].max(axis=0)
    ext = coord_max - coord_min
    inv = [max(ext[0], 1e-9), max(ext[1], 1e-9), max(ext[2], 1e-9)]
    tab = np.empty((len(points6), 9), np.float32)
    tab[:, :6] = points6
    for c in range(3):
        np.divide(points6[:, c], inv[c], out=tab[:, 6 + c])
    return tab


def whole_scene_grid_indices(
    points6: np.ndarray,
    labels: np.ndarray,
    labelweights: np.ndarray,
    block_points: int = 4096,
    block_size: float = 1.0,
    stride: float = 0.5,
    padding: float = 0.001,
    center_xy: bool = True,
    seed: int = 0,
    cells=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Indices-only whole_scene_grid_blocks: the same grid coverage and the
    same pad-resampling rng (idxs are bit-identical at equal seeds), but no
    [nb, P, 9] block tensor is materialized — callers gather rows of
    scene_feature_table() on the device instead (6x less host->device
    traffic, and the dominant host cost of the gridding pass — ~160 MB of
    gather+write per 1M-point vote — disappears). `cells` (a
    precompute_grid_cells handle) reuses the seed-independent membership.

    Returns (idxs [nb, P] int64, weights [nb, P] f32, centers [nb, 2] f32);
    centers are the XY offsets to subtract from gathered coordinates
    (zeros when center_xy=False).
    """
    blocks, _, _, _ = _grid_block_pids(
        points6, block_points, block_size, stride, padding, seed, cells
    )
    if not blocks:
        return (
            np.zeros((0, block_points), np.int64),
            np.zeros((0, block_points), np.float32),
            np.zeros((0, 2), np.float32),
        )
    total_rows = sum(len(pid) for pid, _, _ in blocks)
    nb = total_rows // block_points
    idx = np.empty(total_rows, np.int64)
    centers = np.zeros((nb, 2), np.float32)
    s = 0
    for pid, cx, cy in blocks:
        idx[s : s + len(pid)] = pid
        if center_xy:
            b0 = s // block_points
            centers[b0 : b0 + len(pid) // block_points] = (cx, cy)
        s += len(pid)
    # one gather instead of two: per-point weights [N] first (vote weights
    # depend on idx only through the label), then a single [total] gather
    pw = np.asarray(labelweights, np.float32)[np.asarray(labels, np.int64)]
    wt = pw[idx]
    return (
        idx.reshape(-1, block_points),
        wt.reshape(-1, block_points),
        centers,
    )


def whole_scene_grid_blocks(
    points6: np.ndarray,
    labels: np.ndarray,
    labelweights: np.ndarray,
    block_points: int = 4096,
    block_size: float = 1.0,
    stride: float = 0.5,
    padding: float = 0.001,
    center_xy: bool = True,
    seed: int = 0,
    cells=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Deterministic sliding-grid coverage of a whole scene
    (BridgeDataLoader.py:214-277). center_xy=False keeps the scene
    coordinates unmodified (the BriPCDMulti training contract, where blocks
    carry whole-scene-normalized coordinates).

    Returns (data [nb, block_points, 9], labels [nb, block_points],
    weights [nb, block_points], idxs [nb, block_points]) where idxs are the
    original point indices used for vote accumulation.
    """
    labels = np.ascontiguousarray(labels, dtype=np.int64)
    # Materialize the per-cell member lists (views into one sorted array),
    # then assemble straight into preallocated outputs. On this host fresh
    # pages fault at ~100us/4K, so the naive build-a-list-then-concatenate
    # pattern (f64 intermediates, per-cell temporaries, one giant concat +
    # astype) costs minutes at 5M points; filling f32 outputs in place with
    # reused scratch buffers touches each output byte exactly once.
    blocks, points6, coord_min, coord_max = _grid_block_pids(
        points6, block_points, block_size, stride, padding, seed, cells
    )
    if not blocks:
        return (
            np.zeros((0, block_points, 9), np.float32),
            np.zeros((0, block_points), np.int64),
            np.zeros((0, block_points), np.float32),
            np.zeros((0, block_points), np.int64),
        )
    ext = coord_max - coord_min
    total_rows = sum(len(pid) for pid, _, _ in blocks)
    maxt = max(len(pid) for pid, _, _ in blocks)
    data = np.empty((total_rows, 9), np.float32)
    lab = np.empty(total_rows, np.int64)
    wt = np.empty(total_rows, np.float32)
    idx = np.empty(total_rows, np.int64)
    tmp6 = np.empty((maxt, 6), np.float32)
    inv = [max(ext[0], 1e-9), max(ext[1], 1e-9), max(ext[2], 1e-9)]

    s = 0
    for pid, cx, cy in blocks:
        target = len(pid)
        e = s + target
        seg = data[s:e]
        g6 = tmp6[:target]
        np.take(points6, pid, axis=0, out=g6)
        # normalized channels come from the UNcentered coords; the division
        # is f32 (f32 array / f32 scalar) exactly as in the former
        # build-then-astype path, so outputs are bit-identical
        for c in range(3):
            np.divide(g6[:, c], inv[c], out=seg[:, 6 + c])
        seg[:, :6] = g6
        if center_xy:
            seg[:, 0] -= cx
            seg[:, 1] -= cy
        labseg = lab[s:e]
        np.take(labels, pid, out=labseg)
        wt[s:e] = labelweights[labseg]
        idx[s:e] = pid
        s = e

    return (
        data.reshape(-1, block_points, 9),
        lab.reshape(-1, block_points),
        wt.reshape(-1, block_points),
        idx.reshape(-1, block_points),
    )


def scene_labelweights(
    label_arrays: List[np.ndarray], num_classes: int
) -> np.ndarray:
    """ScannetDatasetWholeScene label weights: cube-root inverse frequency
    (BridgeDataLoader.py:201-213)."""
    hist = np.zeros(num_classes, np.float64)
    for seg in label_arrays:
        tmp, _ = np.histogram(seg, range(num_classes + 1))
        hist += tmp
    hist = np.maximum(hist, 1.0)
    freq = hist / hist.sum()
    return np.power(freq.max() / freq, 1.0 / 3.0).astype(np.float32)


def split_files(
    files: List[str],
    train: float = 0.7,
    val: float = 0.15,
    seed: int = 0,
) -> Tuple[List[str], List[str], List[str]]:
    """70/15/15 file split (utils/prepare_data.py:7-83)."""
    rng = np.random.default_rng(seed)
    files = sorted(files)
    perm = rng.permutation(len(files))
    n_train = int(len(files) * train)
    n_val = int(len(files) * val)
    tr = [files[i] for i in perm[:n_train]]
    va = [files[i] for i in perm[n_train : n_train + n_val]]
    te = [files[i] for i in perm[n_train + n_val :]]
    return tr, va, te
