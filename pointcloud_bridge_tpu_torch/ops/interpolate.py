"""k-NN inverse-distance interpolation (counterpart of
pointcloud_bridge_tpu/ops/interpolate.py).

Exact semantics only: the k nearest sources by iterative first-min (the
lower index on equal distances), weights 1/(d2 + 1e-8) normalised. A CPU
tensor goes to the plain PyTorch version, a CUDA tensor to the kernel
(csrc/interp.cu); the two agree to float32 rounding of the blend.
"""

from __future__ import annotations

import torch

from . import _kernels
from .core import index_points, pairwise_sq_dist

# the kernel keeps the k best neighbours in registers
INTERP_MAX_K = 4


def three_nn_interpolate(
    xyz_dst: torch.Tensor,
    xyz_src: torch.Tensor,
    feats_src: torch.Tensor,
    k: int = 3,
) -> torch.Tensor:
    """Interpolate [B, S, D] source features onto [B, N, 3] positions.

    With one source the features broadcast; with fewer sources than k the
    blend is over all of them (ops/interpolate.py:76-107). Returns
    [B, N, D] float32.
    """
    for name, t in (("xyz_dst", xyz_dst), ("xyz_src", xyz_src), ("feats_src", feats_src)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
    b, n, _ = xyz_dst.shape
    s = xyz_src.shape[1]
    if s == 1:
        return feats_src.expand(b, n, feats_src.shape[2])
    k = min(k, s)
    if xyz_dst.device.type == "cpu":
        return interpolate_plain(xyz_dst, xyz_src, feats_src, k)
    return interpolate_cuda(xyz_dst, xyz_src, feats_src, k)


def interpolate_plain(xyz_dst, xyz_src, feats_src, k: int) -> torch.Tensor:
    """Plain PyTorch interpolation, the counterpart of the Pallas kernel's
    ``_blend_tile``: k rounds of (min, lowest index at the min, mask out)."""
    d2 = pairwise_sq_dist(xyz_dst, xyz_src)  # [B, N, S]
    s = d2.shape[-1]
    ar = torch.arange(s, device=d2.device)
    weights, rows = [], []
    for _ in range(k):
        m = d2.amin(-1, keepdim=True)
        i = torch.where(d2 <= m, ar, s).amin(-1, keepdim=True)
        weights.append(1.0 / (m + 1e-8))
        rows.append(index_points(feats_src, i[..., 0]))
        d2 = d2.scatter(-1, i, float("inf"))
    # sums in selection order, as the kernel accumulates them
    wsum = weights[0]
    for w in weights[1:]:
        wsum = wsum + w
    out = (weights[0] / wsum) * rows[0]
    for w, f in zip(weights[1:], rows[1:]):
        out = out + (w / wsum) * f
    return out


def interpolate_cuda(xyz_dst, xyz_src, feats_src, k: int) -> torch.Tensor:
    """Interpolation kernel wrapper: one launch."""
    _kernels.check_tensor("xyz_dst", xyz_dst, torch.float32, 3)
    _kernels.check_tensor("xyz_src", xyz_src, torch.float32, 3)
    _kernels.check_tensor("feats_src", feats_src, torch.float32, 3)
    b, n, _ = xyz_dst.shape
    s = xyz_src.shape[1]
    d = feats_src.shape[2]
    if (xyz_dst.shape[2] != 3 or xyz_src.shape != (b, s, 3)
            or feats_src.shape[:2] != (b, s)):
        raise ValueError(
            f"interpolate: bad shapes {tuple(xyz_dst.shape)}, "
            f"{tuple(xyz_src.shape)}, {tuple(feats_src.shape)}"
        )
    if not 1 <= k <= min(INTERP_MAX_K, s):
        raise ValueError(f"interpolate kernel takes 1 <= k <= min(4, S), got k={k}, S={s}")
    out = torch.empty((b, n, d), dtype=torch.float32, device=xyz_dst.device)
    if out.numel() == 0:
        return out
    _kernels.INTERPOLATE.launch(
        xyz_dst.data_ptr(), xyz_src.data_ptr(), feats_src.data_ptr(),
        out.data_ptr(), b, n, s, d, k, *_kernels.stream_args(xyz_dst),
    )
    return out
