"""Pure-numpy LAS point-cloud reader/writer (no laspy dependency).

Replaces the reference's laspy usage (L0 in SURVEY.md): readers inside the
datasets return (xyz, rgb/65535, classification) and the LAS exporter mirrors
inference.py:787-810 (point_format=3, rgb scaled by 65535, classification =
predicted label).

Supported: LAS 1.2-1.4, point formats 0-3 (legacy) and 6-8 for reading;
writing emits LAS 1.2 / point format 3 (or 2 when no GPS time is wanted).
A native C++ fast path (native/las_reader) is used when built; this module is
the always-available fallback and the contract definition.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

_HEADER12_SIZE = 227
_POINT_SIZES = {0: 20, 1: 28, 2: 26, 3: 34, 6: 30, 7: 36, 8: 38}
_RGB_OFFSET = {2: 20, 3: 28, 7: 30, 8: 30}  # byte offset of red within record


@dataclass
class LasData:
    """In-memory LAS contents, reference-dataset friendly."""

    xyz: np.ndarray  # [N, 3] float64
    rgb: Optional[np.ndarray]  # [N, 3] uint16 raw (0..65535) or None
    classification: np.ndarray  # [N] uint8
    intensity: Optional[np.ndarray] = None  # [N] uint16
    scales: np.ndarray = field(
        default_factory=lambda: np.array([1e-3, 1e-3, 1e-3])
    )
    offsets: np.ndarray = field(default_factory=lambda: np.zeros(3))

    @property
    def colors01(self) -> Optional[np.ndarray]:
        """Colors normalized to [0,1] (the reference divides by 65535)."""
        if self.rgb is None:
            return None
        return self.rgb.astype(np.float32) / 65535.0


def read_las(path: str) -> LasData:
    """Read a .las file (formats 0-3, 6-8)."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] != b"LASF":
        raise ValueError(f"{path}: not a LAS file (bad signature)")
    ver_major, ver_minor = raw[24], raw[25]
    (offset_to_points,) = struct.unpack_from("<I", raw, 96)
    point_format_raw = raw[104]
    point_format = point_format_raw & 0x3F  # mask compression bit
    if point_format_raw & 0x80:
        raise ValueError(f"{path}: LAZ (compressed) not supported")
    (record_len,) = struct.unpack_from("<H", raw, 105)
    (n_points_legacy,) = struct.unpack_from("<I", raw, 107)
    scales = np.array(struct.unpack_from("<3d", raw, 131))
    offsets = np.array(struct.unpack_from("<3d", raw, 155))
    n_points = n_points_legacy
    if ver_minor >= 4:
        (n64,) = struct.unpack_from("<Q", raw, 247)
        if n64:
            n_points = n64
    if point_format not in _POINT_SIZES:
        raise ValueError(f"{path}: unsupported point format {point_format}")
    base = _POINT_SIZES[point_format]
    if record_len < base:
        raise ValueError(
            f"{path}: record length {record_len} < minimum {base} "
            f"for format {point_format}"
        )

    body = np.frombuffer(
        raw, dtype=np.uint8, count=n_points * record_len, offset=offset_to_points
    ).reshape(n_points, record_len)

    rgb_off = _RGB_OFFSET.get(point_format, -1)
    cls_off, cls_mask = (15, 0x1F) if point_format <= 5 else (16, 0xFF)

    from . import native

    decoded = native.las_decode(
        body, record_len, rgb_off, cls_off, cls_mask, scales, offsets
    )
    if decoded is not None:  # C++ one-pass fast path
        xyz, rgb, cls, intensity = decoded
        return LasData(
            xyz=xyz, rgb=rgb, classification=cls, intensity=intensity,
            scales=scales, offsets=offsets,
        )

    def _view(col_off: int, dtype, n_cols: int = 1):
        sub = body[:, col_off : col_off + np.dtype(dtype).itemsize * n_cols]
        return np.ascontiguousarray(sub).view(dtype).reshape(n_points, n_cols)

    ixyz = _view(0, np.int32, 3).astype(np.float64)
    xyz = ixyz * scales[None, :] + offsets[None, :]
    intensity = _view(12, np.uint16)[:, 0]
    cls = body[:, cls_off] & cls_mask

    rgb = None
    if rgb_off >= 0:
        rgb = _view(rgb_off, np.uint16, 3)

    return LasData(
        xyz=xyz,
        rgb=rgb,
        classification=cls.astype(np.uint8).copy(),
        intensity=intensity.copy(),
        scales=scales,
        offsets=offsets,
    )


def read_las_xyzrgbl(path: str) -> np.ndarray:
    """N x 7 [x y z r g b label] float64 array with rgb in [0,1] — the shared
    reader contract of Partsize-identical/tool_utils/load_las.py:6."""
    las = read_las(path)
    rgb = las.colors01
    if rgb is None:
        rgb = np.zeros((len(las.xyz), 3), np.float32)
    return np.concatenate(
        [las.xyz, rgb.astype(np.float64), las.classification[:, None].astype(np.float64)],
        axis=1,
    )


def write_las(
    path: str,
    xyz: np.ndarray,
    rgb01: Optional[np.ndarray] = None,
    classification: Optional[np.ndarray] = None,
    scales: Tuple[float, float, float] = (1e-3, 1e-3, 1e-3),
) -> None:
    """Write LAS 1.2 point-format 3 (2 if rgb01 is None -> zeros still fmt 3).

    Mirrors create_new_las_file (inference.py:787-810): colors are [0,1]
    floats scaled to uint16 by 65535; classification holds the labels.
    """
    xyz = np.asarray(xyz, np.float64).reshape(-1, 3)
    n = len(xyz)
    if classification is None:
        classification = np.zeros(n, np.uint8)
    classification = np.asarray(classification).astype(np.uint8) & 0x1F
    if rgb01 is None:
        rgb = np.zeros((n, 3), np.uint16)
    else:
        rgb = np.clip(np.asarray(rgb01, np.float64), 0, 1)
        rgb = (rgb * 65535.0).round().astype(np.uint16)

    scales_a = np.asarray(scales, np.float64)
    offsets = xyz.min(axis=0) if n else np.zeros(3)
    ixyz = np.round((xyz - offsets[None, :]) / scales_a[None, :]).astype(np.int32)

    point_format, record_len = 3, 34
    header = bytearray(_HEADER12_SIZE)
    header[0:4] = b"LASF"
    header[24] = 1  # version major
    header[25] = 2  # version minor
    header[26:58] = b"pointcloud_bridge_tpu".ljust(32, b"\x00")
    header[58:90] = b"pcb-tpu lasio".ljust(32, b"\x00")
    struct.pack_into("<H", header, 94, _HEADER12_SIZE)
    struct.pack_into("<I", header, 96, _HEADER12_SIZE)
    struct.pack_into("<I", header, 100, 0)  # no VLRs
    header[104] = point_format
    struct.pack_into("<H", header, 105, record_len)
    struct.pack_into("<I", header, 107, n)
    struct.pack_into("<I", header, 111, n)  # points by return[0]
    struct.pack_into("<3d", header, 131, *scales_a)
    struct.pack_into("<3d", header, 155, *offsets)
    if n:
        mx, mn = xyz.max(axis=0), xyz.min(axis=0)
    else:
        mx = mn = np.zeros(3)
    struct.pack_into("<6d", header, 179, mx[0], mn[0], mx[1], mn[1], mx[2], mn[2])

    body = np.zeros((n, record_len), np.uint8)
    body[:, 0:12] = ixyz.astype("<i4").view(np.uint8).reshape(n, 12)
    # intensity (12:14) zeros; return byte (14) = 1 return
    body[:, 14] = 0x09  # return number 1, number of returns 1
    body[:, 15] = classification
    # scan angle (16), user data (17), point source id (18:20), gps time (20:28) zeros
    body[:, 28:34] = rgb.astype("<u2").view(np.uint8).reshape(n, 6)

    with open(path, "wb") as f:
        f.write(bytes(header))
        f.write(body.tobytes())
