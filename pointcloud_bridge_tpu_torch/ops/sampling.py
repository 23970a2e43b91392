"""Farthest point sampling (counterpart of pointcloud_bridge_tpu/ops/sampling.py).

A CPU tensor goes to the plain PyTorch version, a CUDA tensor to the FPS
kernel (csrc/fps.cu); both give the same indices bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple, Union

import torch

from . import _kernels

# the kernel keeps up to 16 points in each of at most 1024 threads, and a copy
# of the row in shared memory (12 bytes a point)
FPS_MAX_POINTS = 16384
# points a thread where a row takes more than one warp
FPS_PPT = 8
# the integers of a launch, in the order pcb_fps (csrc/fps.cu) reads them
FPS_PLAN = ("b", "n", "npoint", "threads", "ppt")


def farthest_point_sample(
    xyz: torch.Tensor, npoint: int, start_idx: Union[int, torch.Tensor] = 0
) -> torch.Tensor:
    """Iterative farthest point sampling.

    xyz [B, N, 3] float32; start_idx the first centroid, an int or a [B]
    integer tensor. Returns [B, npoint] int32 indices into N. The running
    distance starts at 1e10, is min-folded each step, and the first maximum
    (lowest index) wins (ops/sampling.py:26-95).
    """
    b, n, _ = xyz.shape
    if xyz.dtype != torch.float32:
        raise TypeError(f"xyz: expected float32, got {xyz.dtype}")
    if isinstance(start_idx, int):
        if not 0 <= start_idx < n:
            raise ValueError(f"start_idx {start_idx} out of range for N={n}")
        start = torch.full((b,), start_idx, dtype=torch.int32, device=xyz.device)
    else:
        start = torch.as_tensor(start_idx).to(xyz.device, torch.int32).reshape(b)
        if bool((start < 0).any()) or bool((start >= n).any()):
            raise ValueError(f"start_idx out of range for N={n}")
    if xyz.device.type == "cpu":
        return fps_plain(xyz, npoint, start)
    return fps_cuda(xyz.contiguous(), npoint, start.contiguous())


def fps_plain(xyz: torch.Tensor, npoint: int, start: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch FPS, the counterpart of ``_fps_jnp``: one step a loop."""
    b, n, _ = xyz.shape
    x, y, z = (xyz[..., i] for i in range(3))
    ar = torch.arange(n, device=xyz.device)
    dist = torch.full((b, n), 1e10, dtype=torch.float32, device=xyz.device)
    far = start.long().reshape(b, 1)
    out = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    for i in range(npoint):
        out[:, i] = far[:, 0]
        dx = x - x.gather(1, far)
        dy = y - y.gather(1, far)
        dz = z - z.gather(1, far)
        dist = torch.minimum(dist, (dx * dx + dy * dy) + dz * dz)
        m = dist.amax(1, keepdim=True)
        far = torch.where(dist >= m, ar, n).amin(1, keepdim=True)
    return out


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


@functools.lru_cache(maxsize=None)
def fps_launch(n: int) -> Tuple[int, int]:
    """(threads, points a thread) of csrc/fps.cu for rows of N points: one
    warp for N <= 256, else about FPS_PPT points a thread in whole warps, at
    least a warp for each of the SM's four schedulers and at most 1024
    threads; points a thread a power of two up to 16 with threads * points
    >= N."""
    if not 1 <= n <= FPS_MAX_POINTS:
        raise ValueError(f"fps kernel takes 1 <= N <= {FPS_MAX_POINTS}, got {n}")
    threads = 32 if n <= 256 else min(1024, max(128, -(-n // (FPS_PPT * 32)) * 32))
    return threads, _pow2_at_least(-(-n // threads))


@functools.lru_cache(maxsize=1024)
def _fps_plan(b: int, n: int, npoint: int, threads: int, ppt: int):
    """pcb_fps's plan (FPS_PLAN), checked and laid out once a shape."""
    if not (1 <= n <= FPS_MAX_POINTS and threads % 32 == 0 and 32 <= threads <= 1024
            and ppt in (1, 2, 4, 8, 16) and threads * ppt >= n):
        raise ValueError(f"fps kernel: no launch of {threads} threads x {ppt} points for N={n}")
    if b > 2**31 - 1 or npoint > 2**31 - 1:
        raise ValueError(f"fps kernel takes B, npoint < 2^31, got {b}, {npoint}")
    return (ctypes.c_int * len(FPS_PLAN))(b, n, npoint, threads, ppt)


def fps_cuda(xyz: torch.Tensor, npoint: int, start: torch.Tensor) -> torch.Tensor:
    """FPS kernel wrapper: one launch, [B, npoint] int32 on xyz's device."""
    _kernels.check_tensor("xyz", xyz, torch.float32, 3)
    _kernels.check_tensor("start", start, torch.int32, 1)
    b, n, c = xyz.shape
    if c != 3 or start.shape[0] != b:
        raise ValueError(f"fps: bad shapes xyz {tuple(xyz.shape)}, start {tuple(start.shape)}")
    plan = _fps_plan(b, n, npoint, *fps_launch(n))
    out = torch.empty(b, npoint, dtype=torch.int32, device=xyz.device)
    if b == 0 or npoint == 0:
        return out
    _kernels.FPS.launch(xyz.data_ptr(), start.data_ptr(), out.data_ptr(), plan,
                        *_kernels.stream_args(xyz))
    return out
