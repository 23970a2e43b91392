"""Farthest point sampling and RandLA-Net's random sampling (counterpart
of pointcloud_bridge_tpu/ops/sampling.py).

FPS: a CPU tensor goes to the plain PyTorch version, a CUDA tensor to the
FPS kernel (csrc/fps.cu); both give the same indices bit for bit. The
random subsets draw from an explicit ``torch.Generator``; density-weighted
sampling splits into that draw and a deterministic selection
(``density_weighted_select``) whose k-NN runs on the k-NN kernel.
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
    if torch.compiler.is_compiling():
        return FPS_OP(xyz, npoint, start)
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


def _fps_op_plain(xyz: torch.Tensor, npoint: int, start: torch.Tensor) -> torch.Tensor:
    return fps_plain(xyz, npoint, start)


# pcb::fps, the FPS kernel as a custom op (ops/_kernels.py custom_op)
FPS_OP = _kernels.custom_op(
    "fps", _fps_op_plain,
    lambda xyz, npoint, start: fps_cuda(xyz.contiguous(), npoint, start.contiguous()),
    lambda xyz, npoint, start: xyz.new_empty((xyz.shape[0], npoint), dtype=torch.int32),
)


def random_sample_indices(n: int, npoint: int, batch: int,
                          generator: torch.Generator) -> torch.Tensor:
    """RandLA-Net's random subset (ops/sampling.py:98-110): each row the
    first ``npoint`` of a random permutation of range(n), drawn from
    ``generator`` on its device. The JAX package draws from a PRNG key, so
    the two agree in distribution, not in value. -> [batch, npoint] int32."""
    if not 0 <= npoint <= n:
        raise ValueError(f"random sampling: npoint {npoint} outside [0, {n}]")
    dev = generator.device
    rows = [torch.randperm(n, generator=generator, device=dev)[:npoint] for _ in range(batch)]
    return torch.stack(rows).to(torch.int32) if rows else \
        torch.empty(0, npoint, dtype=torch.int32, device=dev)


# the neighbours whose mean distance stands for 1/density (ops/sampling.py:113)
DENSITY_K = 8


def density_weighted_sample_indices(xyz: torch.Tensor, npoint: int,
                                    generator: torch.Generator) -> torch.Tensor:
    """RandLANet_ss's density-weighted sampling without replacement
    (ops/sampling.py:113-131): a uniform draw ``u`` [B, N] from
    ``generator`` (on xyz's device), then ``density_weighted_select``.
    xyz [B, N, 3] float32 -> [B, npoint] int32."""
    u = torch.rand(xyz.shape[:2], generator=generator, device=xyz.device)
    return density_weighted_select(xyz, npoint, u)


def density_weighted_select(xyz: torch.Tensor, npoint: int, u: torch.Tensor) -> torch.Tensor:
    """The deterministic part of density-weighted sampling: the mean
    distance to the DENSITY_K nearest other points (the DENSITY_K + 1
    nearest, self first, on the k-NN kernel) as 1/density, its log plus the
    Gumbel noise of ``u`` [B, N], and the ``npoint`` largest of that, the
    largest first and equal values to the lower index (``lax.top_k``'s
    order)."""
    from . import grouping  # grouping imports this module

    d2, _ = grouping.knn_with_distance(xyz, k=min(DENSITY_K + 1, xyz.shape[1]))
    sparsity = torch.sqrt(torch.relu(d2[..., 1:])).mean(dim=-1)
    logits = torch.log(sparsity + 1e-8)
    gumbel = -torch.log(-torch.log(u + 1e-12))
    order = (logits + gumbel).sort(dim=-1, descending=True, stable=True).indices
    return order[:, :npoint].to(torch.int32)
