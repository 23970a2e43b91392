"""ctypes bindings for the native C++ preprocessing library (native/preproc.cpp).

Builds libpcbpre.so on first use (g++ -O3), caches it next to the source, and
falls back to numpy implementations when a compiler is unavailable. This is
the TPU-framework equivalent of the reference's numba point filter
(BriPCDMulti.py:179-189) and Open3D voxel downsampling."""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
_SRC = os.path.join(_REPO_ROOT, "native", "preproc.cpp")
_SO = os.path.join(_REPO_ROOT, "native", "libpcbpre.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(
                _SRC
            ):
                subprocess.run(
                    ["g++", "-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC",
                     "-o", _SO, _SRC],
                    check=True,
                    capture_output=True,
                )
            lib = ctypes.CDLL(_SO)
            lib.points_in_block_mask.restype = None
            lib.multi_block_masks.restype = None
            lib.voxel_first_indices.restype = ctypes.c_int64
            lib.voxel_centroids.restype = ctypes.c_int64
            lib.label_histogram.restype = None
            lib.las_decode.restype = None
            lib.grid_ranges.restype = ctypes.c_int64
            lib.grid_scatter.restype = ctypes.c_int64
            _lib = lib
        except Exception:
            _lib_failed = True
    return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def points_in_block_mask(
    points: np.ndarray,
    block_min: np.ndarray,
    block_max: np.ndarray,
    z_threshold: float = 2.0,
) -> np.ndarray:
    """Boolean mask of points inside an xy box with |z - z_center| <= thr."""
    lib = _load()
    pts = np.ascontiguousarray(points[:, :3], np.float32)
    n = len(pts)
    if lib is None:
        zc = (block_min[2] + block_max[2]) / 2.0
        return (
            (pts[:, 0] >= block_min[0])
            & (pts[:, 0] <= block_max[0])
            & (pts[:, 1] >= block_min[1])
            & (pts[:, 1] <= block_max[1])
            & (np.abs(pts[:, 2] - zc) <= z_threshold)
        )
    bmin = np.ascontiguousarray(block_min, np.float32)
    bmax = np.ascontiguousarray(block_max, np.float32)
    out = np.empty(n, np.uint8)
    lib.points_in_block_mask(
        _ptr(pts, ctypes.c_float), ctypes.c_int64(n),
        _ptr(bmin, ctypes.c_float), _ptr(bmax, ctypes.c_float),
        ctypes.c_float(z_threshold), _ptr(out, ctypes.c_uint8),
    )
    return out.astype(bool)


def multi_block_masks(
    points: np.ndarray,
    centers: np.ndarray,
    block_size: float,
    z_threshold: float = 2.0,
) -> np.ndarray:
    """[M, N] boolean masks for M block centers at once."""
    lib = _load()
    pts = np.ascontiguousarray(points[:, :3], np.float32)
    ctr = np.ascontiguousarray(centers[:, :3], np.float32)
    n, m = len(pts), len(ctr)
    if lib is None:
        h = block_size / 2.0
        dx = np.abs(pts[None, :, 0] - ctr[:, 0:1])
        dy = np.abs(pts[None, :, 1] - ctr[:, 1:2])
        dz = np.abs(pts[None, :, 2] - ctr[:, 2:3])
        return (dx <= h) & (dy <= h) & (dz <= z_threshold)
    out = np.empty((m, n), np.uint8)
    lib.multi_block_masks(
        _ptr(pts, ctypes.c_float), ctypes.c_int64(n),
        _ptr(ctr, ctypes.c_float), ctypes.c_int64(m),
        ctypes.c_float(block_size), ctypes.c_float(z_threshold),
        _ptr(out, ctypes.c_uint8),
    )
    return out.astype(bool)


def voxel_first_indices(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """Indices of the first point per voxel, in index order (WL_iden
    data_voxel contract: np.unique(..., return_index=True) keeps the first)."""
    lib = _load()
    pts = np.ascontiguousarray(points[:, :3], np.float64)
    n = len(pts)
    if lib is None:
        coords = np.floor(pts / voxel_size).astype(np.int64)
        _, idx = np.unique(coords, axis=0, return_index=True)
        return np.sort(idx)
    out = np.empty(n, np.int64)
    cnt = lib.voxel_first_indices(
        _ptr(pts, ctypes.c_double), ctypes.c_int64(n),
        ctypes.c_double(voxel_size), _ptr(out, ctypes.c_int64),
    )
    return out[:cnt].copy()


def voxel_centroids(
    points: np.ndarray, voxel_size: float
) -> Tuple[np.ndarray, np.ndarray]:
    """(centroids [M,3], voxel_id per point [N])."""
    lib = _load()
    pts = np.ascontiguousarray(points[:, :3], np.float64)
    n = len(pts)
    if lib is None:
        coords = np.floor(pts / voxel_size).astype(np.int64)
        _, inverse, counts = np.unique(
            coords, axis=0, return_inverse=True, return_counts=True
        )
        cent = np.zeros((len(counts), 3))
        np.add.at(cent, inverse, pts)
        return cent / counts[:, None], inverse
    cent = np.empty((n, 3), np.float64)
    vid = np.empty(n, np.int64)
    m = lib.voxel_centroids(
        _ptr(pts, ctypes.c_double), ctypes.c_int64(n),
        ctypes.c_double(voxel_size),
        _ptr(cent, ctypes.c_double), _ptr(vid, ctypes.c_int64),
    )
    return cent[:m].copy(), vid


def label_histogram(labels: np.ndarray, num_classes: int) -> np.ndarray:
    lib = _load()
    lab = np.ascontiguousarray(labels.reshape(-1), np.int32)
    if lib is None:
        return np.bincount(
            np.clip(lab, 0, num_classes - 1), minlength=num_classes
        ).astype(np.int64)
    out = np.empty(num_classes, np.int64)
    lib.label_histogram(
        _ptr(lab, ctypes.c_int32), ctypes.c_int64(len(lab)),
        ctypes.c_int32(num_classes), _ptr(out, ctypes.c_int64),
    )
    return out


def las_decode(
    body: np.ndarray,
    record_len: int,
    rgb_off: int,
    cls_off: int,
    cls_mask: int,
    scales: np.ndarray,
    offsets: np.ndarray,
):
    """One-pass decode of raw LAS point records (native/preproc.cpp
    ::las_decode). Returns (xyz f64 [N,3], rgb u16 [N,3]|None, cls u8 [N],
    intensity u16 [N]) or None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    body = np.ascontiguousarray(body, np.uint8)
    n = body.size // record_len
    xyz = np.empty((n, 3), np.float64)
    rgb = np.empty((n, 3), np.uint16) if rgb_off >= 0 else np.empty((1, 3), np.uint16)
    cls = np.empty(n, np.uint8)
    inten = np.empty(n, np.uint16)
    scales = np.ascontiguousarray(scales, np.float64)
    offsets = np.ascontiguousarray(offsets, np.float64)
    lib.las_decode(
        _ptr(body, ctypes.c_uint8),
        ctypes.c_int64(n),
        ctypes.c_int32(record_len),
        ctypes.c_int32(rgb_off),
        ctypes.c_int32(cls_off),
        ctypes.c_int32(cls_mask),
        _ptr(scales, ctypes.c_double),
        _ptr(offsets, ctypes.c_double),
        _ptr(xyz, ctypes.c_double),
        _ptr(rgb, ctypes.c_uint16),
        _ptr(cls, ctypes.c_uint8),
        _ptr(inten, ctypes.c_uint16),
    )
    return xyz, (rgb if rgb_off >= 0 else None), cls, inten


def grid_cell_members(
    x: np.ndarray,
    y: np.ndarray,
    lox: np.ndarray,
    hix: np.ndarray,
    loy: np.ndarray,
    hiy: np.ndarray,
):
    """Counting-sort sliding-grid membership (native/preproc.cpp
    ::grid_ranges/::grid_scatter). Returns (offsets int64 [gx*gy+1],
    point_ids int32 [total]) with cell c's members at
    point_ids[offsets[c]:offsets[c+1]], ascending — the exact
    blocks.py::_grid_cell_members contract — or None when the native
    library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float64)
    y = np.ascontiguousarray(y, np.float64)
    lox = np.ascontiguousarray(lox, np.float64)
    hix = np.ascontiguousarray(hix, np.float64)
    loy = np.ascontiguousarray(loy, np.float64)
    hiy = np.ascontiguousarray(hiy, np.float64)
    n, gx, gy = len(x), len(lox), len(loy)
    rng = [np.empty(n, np.int32) for _ in range(4)]
    total = lib.grid_ranges(
        _ptr(x, ctypes.c_double), _ptr(y, ctypes.c_double), ctypes.c_int64(n),
        _ptr(lox, ctypes.c_double), _ptr(hix, ctypes.c_double),
        ctypes.c_int64(gx),
        _ptr(loy, ctypes.c_double), _ptr(hiy, ctypes.c_double),
        ctypes.c_int64(gy),
        _ptr(rng[0], ctypes.c_int32), _ptr(rng[1], ctypes.c_int32),
        _ptr(rng[2], ctypes.c_int32), _ptr(rng[3], ctypes.c_int32),
    )
    offsets = np.empty(gx * gy + 1, np.int64)
    point_ids = np.empty(total, np.int32)
    lib.grid_scatter(
        _ptr(rng[0], ctypes.c_int32), _ptr(rng[1], ctypes.c_int32),
        _ptr(rng[2], ctypes.c_int32), _ptr(rng[3], ctypes.c_int32),
        ctypes.c_int64(n), ctypes.c_int64(gx), ctypes.c_int64(gy),
        _ptr(offsets, ctypes.c_int64), _ptr(point_ids, ctypes.c_int32),
    )
    return offsets, point_ids


def native_available() -> bool:
    return _load() is not None
