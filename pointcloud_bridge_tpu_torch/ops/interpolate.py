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

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _kernels
from .core import index_points, pairwise_sq_dist

# the kernel keeps the k best neighbours in registers
INTERP_MAX_K = 4
# the integers of a launch, in the order pcb_interpolate (csrc/interp.cu)
# reads them
INTERP_PLAN = ("b", "n", "s", "d", "k", "lanes", "chunk", "vec")
# csrc/interp.cu: threads a block; a channel chunk is whole warp widths of
# 16-byte accesses
_INTERP_THREADS = 256
_CHUNK_FLOATS = 128
_LANES_AT_WORK = 2**17
# the integers of a backward launch, in the order pcb_interpolate_backward
# (csrc/interp_bwd.cu) reads them
INTERP_BWD_PLAN = ("b", "n", "s", "d", "k", "rows", "vec")
# csrc/interp_bwd.cu: channels a block, the df rows a block may own
_BWD_CHUNK = 128
_BWD_ROWS = (64, 32, 16, 8)


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
    if torch.compiler.is_compiling():  # an exported program is an inference program
        return INTERPOLATE_OP(xyz_dst, xyz_src, feats_src, k)
    keep = torch.is_grad_enabled() and feats_src.requires_grad
    return Interpolate.apply(xyz_dst, xyz_src, feats_src, k, keep)


class Interpolate(torch.autograd.Function):
    """three_nn_interpolate with the Pallas VJP's backward. ``keep``: a
    backward will follow, so the forward keeps the selection for it."""

    @staticmethod
    def forward(ctx, xyz_dst, xyz_src, feats_src, k: int, keep: bool):
        if xyz_dst.device.type == "cpu":
            out, idx, w = interpolate_plain(xyz_dst, xyz_src, feats_src, k, keep)
        else:
            out, idx, w = interpolate_cuda(xyz_dst.contiguous(), xyz_src.contiguous(),
                                           feats_src.contiguous(), k, keep)
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


def _interpolate_op_plain(xyz_dst: torch.Tensor, xyz_src: torch.Tensor, feats_src: torch.Tensor,
                          k: int) -> torch.Tensor:
    return interpolate_plain(xyz_dst, xyz_src, feats_src, k)[0]


# pcb::interpolate, the interpolation kernel as a custom op (ops/_kernels.py
# custom_op), the blend alone
INTERPOLATE_OP = _kernels.custom_op(
    "interpolate", _interpolate_op_plain,
    lambda xyz_dst, xyz_src, feats_src, k: interpolate_cuda(
        xyz_dst.contiguous(), xyz_src.contiguous(), feats_src.contiguous(), k)[0],
    lambda xyz_dst, xyz_src, feats_src, k: feats_src.new_empty(
        (*xyz_dst.shape[:2], feats_src.shape[2])),
)


def interp_lanes(queries: int) -> int:
    """Lanes that select for one query in csrc/interp.cu, by the number of
    queries B * N: the fewest of 4, 8, 16 and 32 that put 2^17 lanes to work
    (a wave of the card's 132 SMs at about 1000 threads each). Fewer lanes
    a query scan longer but merge less, which pays where the queries alone
    fill the card."""
    for lanes in (4, 8, 16):
        if queries * lanes >= _LANES_AT_WORK:
            return lanes
    return 32


def interp_chunk(blocks: int, d: int, sms: int) -> int:
    """Channels a block of csrc/interp.cu blends, where ``blocks`` blocks
    cover the rows: all D where that gives the card two blocks an SM, else
    D cut into chunks of whole warp widths (128 channels), as many as it
    takes to get there and at most one a warp width."""
    if blocks >= 2 * sms or d <= _CHUNK_FLOATS:
        return max(d, 1)
    chunks = min(-(-2 * sms // blocks), -(-d // _CHUNK_FLOATS))
    width = -(-d // chunks)
    return min(d, -(-width // _CHUNK_FLOATS) * _CHUNK_FLOATS)


@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=1024)
def _interp_plan(b: int, n: int, s: int, d: int, k: int, vec: bool, sms: int,
                 lanes: Optional[int] = None):
    """pcb_interpolate's plan (INTERP_PLAN), checked and laid out once a
    shape: ``interp_lanes`` lanes a query (or ``lanes``), and the channel
    chunk that gives ``sms`` SMs two blocks each where the rows allow."""
    if b > 65535 or b * n >= 2**31:
        raise ValueError(f"interpolate kernel takes B <= 65535 and B * N < 2^31, got B={b}, N={n}")
    lanes = lanes or interp_lanes(b * n)
    if lanes not in (4, 8, 16, 32):
        raise ValueError(f"interpolate kernel: 4, 8, 16 or 32 lanes a query, got {lanes}")
    blocks = -(-n // (_INTERP_THREADS // lanes)) * b
    return (ctypes.c_int * len(INTERP_PLAN))(b, n, s, d, k, lanes, interp_chunk(blocks, d, sms),
                                             vec)


def interpolate_cuda(
    xyz_dst, xyz_src, feats_src, k: int, keep: bool = False
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Interpolation kernel wrapper -> (out, idx, w) as ``interpolate_plain``;
    with ``keep`` the kernel also writes idx and w. 16-byte accesses where D
    is a multiple of 4 and both feats_src and the output are 16-byte aligned
    (a contiguous view at an offset need not be)."""
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
    out = torch.empty(b, n, d, dtype=torch.float32, device=dev)
    vec = d % 4 == 0 and feats_src.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    plan = _interp_plan(b, n, s, d, k, vec, _sm_count(dev.index))
    idx = w = None
    if keep:
        idx = torch.empty(b, n, k, dtype=torch.int32, device=dev)
        w = torch.empty(b, n, k, dtype=torch.float32, device=dev)
    if b * n == 0:
        return out, idx, w
    _kernels.INTERPOLATE.launch(
        xyz_dst.data_ptr(), xyz_src.data_ptr(), feats_src.data_ptr(), out.data_ptr(),
        idx.data_ptr() if keep else None, w.data_ptr() if keep else None, plan,
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


def bwd_rows(b: int, s: int, d: int, sms: int) -> int:
    """df rows a block of csrc/interp_bwd.cu owns: the most of 64, 32, 16
    and 8 whose blocks (B x row groups x 128-channel chunks) still number
    at least the card's SMs, else 8. Each block scans its batch element's
    whole selection, so fewer rows a block cost more scanning."""
    chunks = -(-d // _BWD_CHUNK)
    for rows in _BWD_ROWS[:-1]:
        if b * -(-s // rows) * chunks >= sms:
            return rows
    return _BWD_ROWS[-1]


@functools.lru_cache(maxsize=1024)
def _interp_bwd_plan(b: int, n: int, s: int, d: int, k: int, vec: bool, sms: int,
                     rows: Optional[int] = None):
    """pcb_interpolate_backward's plan (INTERP_BWD_PLAN), checked and laid
    out once a shape: ``bwd_rows`` df rows a block (or ``rows``)."""
    if b > 65535 or b * n * k >= 2**31 or n >= 2**25:
        raise ValueError(f"interpolate backward kernel takes B <= 65535, N < 2^25 and "
                         f"B * N * k < 2^31, got B={b}, N={n}, k={k}")
    if not 1 <= k <= INTERP_MAX_K or s < 1 or d < 1:
        raise ValueError(f"interpolate backward kernel takes 1 <= k <= 4, S >= 1 and D >= 1, "
                         f"got k={k}, S={s}, D={d}")
    rows = rows or bwd_rows(b, s, d, sms)
    if rows not in _BWD_ROWS:
        raise ValueError(f"interpolate backward kernel: 8, 16, 32 or 64 rows a block, got {rows}")
    return (ctypes.c_int * len(INTERP_BWD_PLAN))(b, n, s, d, k, rows, vec)


def interpolate_backward_cuda(
    g: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, s: int
) -> torch.Tensor:
    """Interpolation-backward kernel wrapper: one launch (csrc/interp_bwd.cu),
    which writes every element of df (no memset) and adds each row's terms
    in ascending (query, slot) order, the same bits from call to call.
    16-byte accesses where D is a multiple of 4 and g is 16-byte aligned."""
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
    if g.numel() >= 2**31 or b * s * d >= 2**31:
        raise ValueError("interpolate backward kernel takes < 2^31 elements")
    df = torch.empty((b, s, d), dtype=torch.float32, device=g.device)
    if df.numel() == 0:
        return df
    vec = d % 4 == 0 and g.data_ptr() % 16 == 0 and df.data_ptr() % 16 == 0
    plan = _interp_bwd_plan(b, n, s, d, k, vec, _kernels.sm_count(g.get_device()))
    _kernels.INTERP_BWD.launch(g.data_ptr(), idx.data_ptr(), w.data_ptr(), df.data_ptr(), plan,
                               *_kernels.stream_args(g))
    return df
