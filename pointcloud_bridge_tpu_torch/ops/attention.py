"""Multi-head attention on [B, N, H, D] tensors (counterpart of
pointcloud_bridge_tpu/models/ptv3.py::_attention, :74-172).

One route a device: a CPU tensor takes the plain PyTorch version, which is
what ``jax.nn.dot_product_attention`` computes on the CPU; a CUDA tensor
takes the flash-attention kernels (csrc/flash_attn.cu, flash_attn_bwd.cu),
which keep the [B, H, N, N] scores out of device memory, at every length and
for global and windowed attention alike (a window fold is a larger batch of
shorter rows). q, k and v are all float32 or all bfloat16. In float32 the
kernels multiply on the tensor cores in 3xTF32, float32 in and out at
float32 accuracy; :func:`split_tf32` and :func:`einsum_3xtf32` are that
arithmetic in plain PyTorch, for the tests. In bfloat16 (a model that
computes or streams in bf16) their bf16 flavours (csrc/flash_attn_bf16.cu,
flash_attn_bwd_bf16.cu) compute what ``jax.nn.dot_product_attention`` does
in bf16: scores from bf16 operands summed in float32, the softmax in
float32, the probabilities rounded to bf16 before they multiply v, the
output rounded to bf16; the plain versions do the same in float32 from the
bf16 inputs, rounding where the kernels round (a product of two bf16
numbers is exact in float32). The JAX function's environment switches, its
pad of D = 192 to 256 and its quiet fallback are the TPU kernel's and are
not carried over.

:class:`Attention` is an autograd Function on both devices, so the CPU tests
build the graph that the card runs. Where an input needs a gradient, the
forward also keeps each row's log-sum-exp of the scaled scores, and the
backward recomputes the probabilities from it: the plain formulas of
:func:`attention_backward_plain` on the CPU, the two backward kernels on the
card. In bf16 the backward follows the same contract: dP = dO . v^T and
delta = rowsum(dO * O) in float32, dS = P * (dP - delta) in float32 and
rounded to bf16 as an operand, as P is for dv; dq, dk and dv summed in
float32 and returned in bf16.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from . import _kernels

# head widths the kernels are instantiated for
FLASH_HEAD_DIMS = tuple(range(32, 257, 32))
# The bf16 kernels' tile plan, csrc/flash_attn_bf16.cuh PCB_BF16_PLAN: D ->
# (keys a forward step, forward stages, keys a dq step, dq stages, queries a
# dk/dv step, dk/dv stages, whether dk/dv splits its two sums between the
# block's consumer warpgroups). A consumer warpgroup owns BF16_ROWS rows;
# a TMA box and a shared-memory column block are BF16_BOX channels (the
# 64-byte swizzle). The CPU tests hold this table to the C one.
BF16_PLAN = {
    32: (128, 4, 64, 4, 64, 4, False),
    64: (128, 4, 64, 4, 64, 4, False),
    96: (128, 3, 64, 4, 64, 4, False),
    128: (64, 4, 64, 4, 32, 4, False),
    160: (64, 4, 64, 3, 64, 4, True),
    192: (64, 3, 32, 4, 64, 3, True),
    224: (64, 3, 32, 4, 32, 4, True),
    256: (32, 4, 32, 3, 32, 4, True),
}
BF16_ROWS, BF16_BOX = 64, 32


def bf16_smem_bytes(d: int) -> tuple:
    """Dynamic shared memory of a block of the three bf16 kernels at head
    width d (forward, dq, dk/dv), as csrc/flash_attn_bf16.cuh smem_bytes
    counts it: 1024 bytes of alignment slack, the resident 64-row tiles, the
    ring of stages x 2 tiles, dk/dv's (lse, delta) of a stage's queries and
    8 bytes a barrier (two a stage and one)."""
    fbn, fst, qbn, qst, kbq, kst, split = BF16_PLAN[d]

    def block(resident, bn, stages, stats=0):
        return (1024 + resident * BF16_ROWS * d * 2 + stages * 2 * bn * d * 2 + 4 * stats
                + 8 * (2 * stages + 1))

    return block(2, fbn, fst), block(4, qbn, qst), block(2 if split else 4, kbq, kst, 2 * kst * kbq)
# the types the kernels take, with their entry points (forward, dq, dk/dv)
_KERNELS_BY_DTYPE = {
    torch.float32: (_kernels.FLASH_ATTN, _kernels.FLASH_ATTN_BWD_DQ,
                    _kernels.FLASH_ATTN_BWD_DKV),
    torch.bfloat16: (_kernels.FLASH_ATTN_BF16, _kernels.FLASH_ATTN_BWD_DQ_BF16,
                     _kernels.FLASH_ATTN_BWD_DKV_BF16),
}


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q . k^T / sqrt(D)) . v a batch row and head.

    q, k, v [B, N, H, D], all float32 or all bfloat16, the JAX layout; any
    strides (the three slices of a packed qkv projection are read in place)
    -> [B, N, H, D] in their type, contiguous. Differentiable in q, k and v,
    but not while exported: an exported program is an inference program.
    """
    _check(q, k, v)
    if torch.compiler.is_compiling():
        return ATTENTION_OP(q, k, v)[0]
    return Attention.apply(q, k, v)


class Attention(torch.autograd.Function):
    """attention() with its backward. It saves q, k and v as the views it
    was given (three slices of one packed projection share their storage),
    the output and the [B, H, N] log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v):
        need_grad = any(ctx.needs_input_grad)
        if q.device.type == "cpu":
            out, scores = _forward_plain(q, k, v)
            if need_grad:
                lse = torch.logsumexp(scores, dim=-1)
        elif need_grad:
            out, lse = attention_cuda(q, k, v, need_lse=True)
        else:
            out = attention_cuda(q, k, v)
        if need_grad:
            ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable  # the kernels build no graph
    def backward(ctx, grad_out):
        q, k, v, out, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            return attention_backward_plain(q, k, v, out, lse, grad_out)
        return attention_backward_cuda(q, k, v, out, lse, grad_out)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dtype not in _KERNELS_BY_DTYPE:
        raise TypeError(f"attention: q: expected float32 or bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"attention: {name}: expected {q.dtype} as q, got {t.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"attention: expected three [B, N, H, D] tensors of one shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )


def _scores(q: torch.Tensor, k: torch.Tensor, einsum=torch.einsum) -> torch.Tensor:
    """The [B, H, N, N] scores, scaled by 1/sqrt(D)."""
    return einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(q.shape[-1]))


def _weighted_sum(p: torch.Tensor, v: torch.Tensor, einsum=torch.einsum) -> torch.Tensor:
    return einsum("bhqk,bkhd->bqhd", p, v).contiguous()


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to bf16 (nearest even) and back: an operand of a
    bf16 product."""
    return x.to(torch.bfloat16).float()


def _forward_plain(q, k, v, einsum=torch.einsum):
    """(output, the float32 scaled scores) of the plain attention."""
    if q.dtype != torch.bfloat16:
        scores = _scores(q, k, einsum)
        return _weighted_sum(torch.softmax(scores, dim=-1), v, einsum), scores
    scores = _scores(q.float(), k.float(), einsum)
    p = _bf16_round(torch.softmax(scores, dim=-1))
    return _weighted_sum(p, v.float(), einsum).to(torch.bfloat16), scores


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    einsum=torch.einsum) -> torch.Tensor:
    """Plain PyTorch attention: the [B, H, N, N] scores, scaled by 1/sqrt(D),
    a softmax over the keys, and the weighted sum of v. float32 inputs are
    computed in float32; bfloat16 inputs as ``jax.nn.dot_product_attention``
    computes them: in float32 from the bf16 values, with the probabilities
    rounded to bf16 before the second product and the output rounded to
    bf16. ``einsum`` computes the two products (the tests pass
    :func:`einsum_3xtf32`, the float32 kernels' arithmetic)."""
    return _forward_plain(q, k, v, einsum)[0]


def attention_backward_plain(q, k, v, out, lse, grad_out, einsum=torch.einsum):
    """Plain PyTorch backward of attention (the plain version of the two
    backward kernels) -> (dq, dk, dv), each [B, N, H, D] contiguous.

    ``out`` is the forward's result, ``lse`` [B, H, N] the log-sum-exp of its
    scaled scores, ``grad_out`` [B, N, H, D]. With P = exp(S - lse),
    delta_i = sum_d out * grad_out, dP = grad_out . v^T and
    dS = P * (dP - delta): dv = P^T . grad_out, dq = dS . k / sqrt(D),
    dk = dS^T . q / sqrt(D). ``einsum`` computes the five products.

    bfloat16 inputs are computed in float32 from their values; P and dS are
    rounded to bf16 where they enter a product, as the kernels round them,
    and dq, dk, dv to bf16 at the end."""
    if q.dtype == torch.bfloat16:
        return _backward_plain_bf16(q, k, v, out, lse, grad_out, einsum)
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(_scores(q, k, einsum) - lse.unsqueeze(-1))
    dv = einsum("bhqk,bqhd->bkhd", p, grad_out)
    dp = einsum("bqhd,bkhd->bhqk", grad_out, v)
    delta = (out * grad_out).sum(-1).transpose(1, 2)  # [B, H, N]
    ds = p * (dp - delta.unsqueeze(-1))
    dq = einsum("bhqk,bkhd->bqhd", ds, k) * scale
    dk = einsum("bhqk,bqhd->bkhd", ds, q) * scale
    return dq.contiguous(), dk.contiguous(), dv.contiguous()


def _backward_plain_bf16(q, k, v, out, lse, grad_out, einsum=torch.einsum):
    q, k, v, out, g = (t.float() for t in (q, k, v, out, grad_out))
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(_scores(q, k, einsum) - lse.unsqueeze(-1))
    dv = einsum("bhqk,bqhd->bkhd", _bf16_round(p), g)
    dp = einsum("bqhd,bkhd->bhqk", g, v)
    delta = (out * g).sum(-1).transpose(1, 2)  # [B, H, N]
    ds = _bf16_round(p * (dp - delta.unsqueeze(-1)))
    dq = einsum("bhqk,bkhd->bqhd", ds, k) * scale
    dk = einsum("bhqk,bqhd->bkhd", ds, q) * scale
    return tuple(t.to(torch.bfloat16).contiguous() for t in (dq, dk, dv))


def _tf32_bits(x: torch.Tensor) -> torch.Tensor:
    """x with the 13 mantissa bits that a TF32 operand lacks set to 0: what a
    tensor core reads of a float32."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """float32 x -> (big, small) as the kernels split an operand
    (csrc/flash_attn.cuh). big is x rounded to TF32, 10 mantissa bits, to
    nearest with ties away from zero, as ``cvt.rna.tf32.f32`` rounds: half a
    TF32 ulp added to the bit pattern, then cut. small is what a tensor core
    reads of the exact rest x - big. x = big + small up to 2^-21 |x|."""
    if x.dtype != torch.float32:
        raise TypeError(f"split_tf32: expected float32, got {x.dtype}")
    big = _tf32_bits((x.contiguous().view(torch.int32) + 0x1000).view(torch.float32))
    return big, _tf32_bits(x - big)


def einsum_3xtf32(equation: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` of two float32 tensors as the kernels multiply
    (3xTF32): small . big + big . small + big . big over the TF32 halves of
    both operands. The products of two TF32 numbers are exact in float64,
    where the sums are taken here, so what differs from the exact product is
    the split's doing: the dropped small . small and the cut of small."""
    (a_big, a_small), (b_big, b_small) = split_tf32(a), split_tf32(b)
    a_big, a_small, b_big, b_small = (t.double() for t in (a_big, a_small, b_big, b_small))
    out = (torch.einsum(equation, a_small, b_big) + torch.einsum(equation, a_big, b_small)
           + torch.einsum(equation, a_big, b_big))
    return out.float()


def _rows(t: torch.Tensor) -> torch.Tensor:
    """t as the kernel reads it: [H, D] contiguous inside a row, the batch
    stride N rows, rows 16-byte aligned (a row stride of a multiple of 4
    float32 or 8 bf16 elements; the bf16 kernels' TMA asks the same of a
    global address and stride). A packed-qkv slice and its window fold pass
    as they are; anything else is copied into a fresh, aligned buffer (a
    contiguous view off 16-byte alignment too, which ``.contiguous()`` would
    hand back as it is)."""
    _, n, h, d = t.shape
    ok = (
        t.stride(3) == 1 and t.stride(2) == d and t.stride(1) >= h * d
        and t.stride(0) == n * t.stride(1) and t.stride(1) * t.element_size() % 16 == 0
        and t.data_ptr() % 16 == 0
    )
    return t if ok else t.clone(memory_format=torch.contiguous_format)


def _check_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise on what the kernels do not take."""
    _check(q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"attention: {name}: expected a CUDA tensor, got {t.device}")
    b, n, h, d = q.shape
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(
            f"attention kernel takes a head width of {FLASH_HEAD_DIMS}, got D={d}"
        )
    # the most blocks a launch takes: a block per 64 rows (the float32
    # kernels; the bf16 kernels where a block has one consumer warpgroup, and
    # bf16 dk/dv with its split)
    if b * h * ((n + BF16_ROWS - 1) // BF16_ROWS) >= 2**31:
        raise ValueError(f"attention kernel takes < 2^31 blocks, got {tuple(q.shape)}")


def attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   need_lse: bool = False):
    """Flash-attention kernel wrapper: one launch (csrc/flash_attn.cu in
    float32, flash_attn_bf16.cu in bfloat16) -> the output in q's type, or
    with ``need_lse`` (output, lse [B, H, N] float32)."""
    _check_cuda(q, k, v)
    b, n, h, d = q.shape
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device) if need_lse else None
    if out.numel():
        q, k, v = _rows(q), _rows(k), _rows(v)
        _KERNELS_BY_DTYPE[q.dtype][0].launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if need_lse else None, b, n, h, d,
            q.stride(1), k.stride(1), v.stride(1), *_kernels.stream_args(q),
        )
    return (out, lse) if need_lse else out


def _attention_op_plain(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    out, scores = _forward_plain(q, k, v)
    return out, torch.logsumexp(scores, dim=-1)


# pcb::attention, the flash-attention forward (float32 or bf16 by the
# inputs' type) as a custom op (ops/_kernels.py custom_op) -> (out, lse)
ATTENTION_OP = _kernels.custom_op(
    "attention", _attention_op_plain,
    lambda q, k, v: attention_cuda(q, k, v, need_lse=True),
    lambda q, k, v: (q.new_empty(q.shape),
                     q.new_empty((q.shape[0], q.shape[2], q.shape[1]), dtype=torch.float32)),
)


def _dense(t: torch.Tensor) -> torch.Tensor:
    """t contiguous and 16-byte aligned, as the backward kernels read the
    output and its gradient (16-byte loads, ``cp.async``, TMA): t itself where
    it is, else a copy (``.contiguous()`` would hand back a contiguous view
    off alignment as it is)."""
    ok = t.is_contiguous() and t.data_ptr() % 16 == 0
    return t if ok else t.clone(memory_format=torch.contiguous_format)


def _check_saved(**tensors) -> None:
    """Raise unless each name=(tensor, shape, dtype) is a contiguous, 16-byte
    aligned CUDA tensor of that shape and type."""
    for name, (t, shape, dtype) in tensors.items():
        _kernels.check_tensor(f"attention backward: {name}", t, dtype, len(shape))
        if tuple(t.shape) != shape:
            raise ValueError(
                f"attention backward: {name}: expected {shape}, got {tuple(t.shape)}")
        if t.data_ptr() % 16:
            raise ValueError(f"attention backward: {name}: expected 16-byte alignment")


def attention_backward_dq_cuda(q, k, v, out, lse, grad_out):
    """The dq kernel's wrapper: one launch (csrc/flash_attn_bwd.cu, or
    flash_attn_bwd_bf16.cu in bfloat16) -> (dq [B, N, H, D] in q's type,
    delta [B, H, N] float32), delta_i = sum_d out * grad_out, which the dk/dv
    kernel reads."""
    _check_cuda(q, k, v)
    b, n, h, d = q.shape
    _check_saved(out=(out, (b, n, h, d), q.dtype), grad_out=(grad_out, (b, n, h, d), q.dtype),
                 lse=(lse, (b, h, n), torch.float32))
    dq = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    delta = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    if dq.numel():
        q, k, v = _rows(q), _rows(k), _rows(v)
        _KERNELS_BY_DTYPE[q.dtype][1].launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), grad_out.data_ptr(),
            lse.data_ptr(), dq.data_ptr(), delta.data_ptr(), b, n, h, d,
            q.stride(1), k.stride(1), v.stride(1), *_kernels.stream_args(q),
        )
    return dq, delta


def attention_backward_dkv_cuda(q, k, v, lse, delta, grad_out):
    """The dk/dv kernel's wrapper: one launch (csrc/flash_attn_bwd.cu, or
    flash_attn_bwd_bf16.cu in bfloat16) -> (dk, dv), each [B, N, H, D] in
    q's type; ``delta`` is the dq kernel's."""
    _check_cuda(q, k, v)
    b, n, h, d = q.shape
    _check_saved(grad_out=(grad_out, (b, n, h, d), q.dtype),
                 lse=(lse, (b, h, n), torch.float32), delta=(delta, (b, h, n), torch.float32))
    dk = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    if dk.numel():
        q, k, v = _rows(q), _rows(k), _rows(v)
        _KERNELS_BY_DTYPE[q.dtype][2].launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), grad_out.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, n, h, d,
            q.stride(1), k.stride(1), v.stride(1), *_kernels.stream_args(q),
        )
    return dk, dv


def attention_backward_cuda(q, k, v, out, lse, grad_out):
    """Backward of attention on the card: the dq kernel, then the dk/dv
    kernel on the delta it wrote -> (dq, dk, dv)."""
    out, grad_out = _dense(out), _dense(grad_out)
    dq, delta = attention_backward_dq_cuda(q, k, v, out, lse, grad_out)
    dk, dv = attention_backward_dkv_cuda(q, k, v, lse, delta, grad_out)
    return dq, dk, dv
