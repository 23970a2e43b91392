"""k-NN inverse-distance interpolation (counterpart of
pointcloud_bridge_tpu/ops/interpolate.py).

Exact semantics only: the k nearest sources by iterative first-min (the
lower index on equal distances), weights 1/(d2 + 1e-8) normalised. A CPU
tensor goes to the plain PyTorch version, a CUDA tensor to the kernel
(csrc/interp.cu); the two agree to float32 rounding of the blend.

``three_nn_interpolate`` is the autograd Function :class:`Interpolate` on
both devices. Its backward is the Pallas VJP's (interp3.py:136-204): the
source features get blend^T . g (csrc/interp_bwd.cu on the card), and the
coordinates get none, which is exact wherever they depend on no parameter,
as in every FP layer. When a backward will follow, the forward keeps each
query's k indices and weights for it.
"""

from __future__ import annotations

from typing import Optional, Tuple

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
    [B, N, D] float32, differentiable in feats_src.
    """
    for name, t in (("xyz_dst", xyz_dst), ("xyz_src", xyz_src), ("feats_src", feats_src)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
    b, n, _ = xyz_dst.shape
    s = xyz_src.shape[1]
    if s == 1:
        return feats_src.expand(b, n, feats_src.shape[2])
    k = min(k, s)
    keep = torch.is_grad_enabled() and feats_src.requires_grad
    return Interpolate.apply(xyz_dst, xyz_src, feats_src, k, keep)


class Interpolate(torch.autograd.Function):
    """three_nn_interpolate with the Pallas VJP's backward. ``keep``: a
    backward will follow, so the forward keeps the selection for it."""

    @staticmethod
    def forward(ctx, xyz_dst, xyz_src, feats_src, k: int, keep: bool):
        cpu = xyz_dst.device.type == "cpu"
        if cpu:
            out, idx, w = interpolate_plain(xyz_dst, xyz_src, feats_src, k, keep)
        else:
            out, idx, w = interpolate_cuda(xyz_dst, xyz_src, feats_src, k, keep)
        if keep:
            ctx.save_for_backward(idx, w)
            ctx.s = xyz_src.shape[1]
        return out

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[2]:
            return None, None, None, None, None
        idx, w = ctx.saved_tensors
        if g.device.type == "cpu":
            df = interpolate_backward_plain(g, idx, w, ctx.s)
        else:
            df = interpolate_backward_cuda(g.contiguous(), idx, w, ctx.s)
        return None, None, df, None, None


def interpolate_select_plain(xyz_dst, xyz_src, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k nearest sources of every destination point and their
    normalised weights, the counterpart of the Pallas kernel's
    ``_blend_tile``: k rounds of (min, lowest index at the min, mask out),
    weights summed in selection order. -> idx [B, N, k] int64, w [B, N, k]."""
    d2 = pairwise_sq_dist(xyz_dst, xyz_src)  # [B, N, S]
    s = d2.shape[-1]
    ar = torch.arange(s, device=d2.device)
    weights, rows = [], []
    for _ in range(k):
        m = d2.amin(-1, keepdim=True)
        i = torch.where(d2 <= m, ar, s).amin(-1, keepdim=True)
        weights.append(1.0 / (m + 1e-8))
        rows.append(i)
        d2 = d2.scatter(-1, i, float("inf"))
    wsum = weights[0]
    for w in weights[1:]:
        wsum = wsum + w
    return torch.cat(rows, -1), torch.cat([w / wsum for w in weights], -1)


def interpolate_plain(
    xyz_dst, xyz_src, feats_src, k: int, keep: bool = False
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Plain PyTorch interpolation -> (out [B, N, D], idx, w); idx and w are
    the selection (int32, float32 [B, N, k]) when ``keep``, else None. The
    blend adds the k weighted rows in selection order, as the kernel does."""
    idx, w = interpolate_select_plain(xyz_dst, xyz_src, k)
    out = w[..., 0:1] * index_points(feats_src, idx[..., 0])
    for t in range(1, k):
        out = out + w[..., t:t + 1] * index_points(feats_src, idx[..., t])
    if not keep:
        return out, None, None
    return out, idx.to(torch.int32), w


def interpolate_cuda(
    xyz_dst, xyz_src, feats_src, k: int, keep: bool = False
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Interpolation kernel wrapper: one launch -> (out, idx, w) as
    ``interpolate_plain``; with ``keep`` the kernel also writes idx and w."""
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
    dev = xyz_dst.device
    out = torch.empty((b, n, d), dtype=torch.float32, device=dev)
    idx = w = None
    if keep:
        idx = torch.empty((b, n, k), dtype=torch.int32, device=dev)
        w = torch.empty((b, n, k), dtype=torch.float32, device=dev)
    if b * n == 0:
        return out, idx, w
    _kernels.INTERPOLATE.launch(
        xyz_dst.data_ptr(), xyz_src.data_ptr(), feats_src.data_ptr(),
        out.data_ptr(), idx.data_ptr() if keep else None,
        w.data_ptr() if keep else None, b, n, s, d, k,
        *_kernels.stream_args(xyz_dst),
    )
    return out, idx, w


def interpolate_backward_plain(
    g: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, s: int
) -> torch.Tensor:
    """Plain df = blend^T . g: g [B, N, D], idx/w [B, N, k] -> [B, S, D],
    each query's k weighted rows scatter-added onto their sources."""
    b, n, d = g.shape
    k = idx.shape[-1]
    src = (w.unsqueeze(-1) * g.unsqueeze(2)).reshape(b, n * k, d)
    flat = idx.reshape(b, n * k, 1).long().expand(-1, -1, d)
    out = torch.zeros((b, s, d), dtype=g.dtype, device=g.device)
    return out.scatter_add_(1, flat, src)


def interpolate_backward_cuda(
    g: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, s: int
) -> torch.Tensor:
    """Interpolation-backward kernel wrapper: one launch (csrc/interp_bwd.cu)."""
    _kernels.check_tensor("g", g, torch.float32, 3)
    _kernels.check_tensor("idx", idx, torch.int32, 3)
    _kernels.check_tensor("w", w, torch.float32, 3)
    b, n, d = g.shape
    k = idx.shape[2]
    if idx.shape[:2] != (b, n) or w.shape != idx.shape or not 1 <= k <= INTERP_MAX_K:
        raise ValueError(
            f"interpolate backward: bad shapes g {tuple(g.shape)}, "
            f"idx {tuple(idx.shape)}, w {tuple(w.shape)}"
        )
    df = torch.empty((b, s, d), dtype=torch.float32, device=g.device)
    if g.numel() >= 2**31 or df.numel() >= 2**31:
        raise ValueError("interpolate backward kernel takes < 2^31 elements")
    if b * n == 0:
        return df.zero_()
    _kernels.INTERP_BWD.launch(
        g.data_ptr(), idx.data_ptr(), w.data_ptr(), df.data_ptr(), b, n, s, d, k,
        *_kernels.stream_args(g),
    )
    return df
