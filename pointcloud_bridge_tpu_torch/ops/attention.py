"""Multi-head attention on [B, N, H, D] tensors (counterpart of
pointcloud_bridge_tpu/models/ptv3.py::_attention, :74-172).

One route a device: a CPU tensor takes the plain PyTorch version, which is
what ``jax.nn.dot_product_attention`` computes on the CPU; a CUDA tensor
takes the flash-attention kernel (csrc/flash_attn.cu), which keeps the
[B, H, N, N] scores out of device memory, at every length and for global and
windowed attention alike (a window fold is a larger batch of shorter rows).
The JAX function's environment switches, its pad of D = 192 to 256 and its
quiet fallback are the TPU kernel's and are not carried over.

The kernel has no backward yet: on a CUDA tensor that needs a gradient the
wrapper raises (ROADMAP.md, Queue 2).
"""

from __future__ import annotations

import math

import torch

from . import _kernels

# head widths the kernel is instantiated for
FLASH_HEAD_DIMS = tuple(range(32, 257, 32))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q . k^T / sqrt(D)) . v a batch row and head.

    q, k, v [B, N, H, D] float32, the JAX layout; any strides (the three
    slices of a packed qkv projection are read in place) -> [B, N, H, D]
    float32, contiguous.
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    return attention_cuda(q, k, v)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"attention: {name}: expected float32, got {t.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"attention: expected three [B, N, H, D] tensors of one shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch attention: the [B, H, N, N] scores, scaled by 1/sqrt(D),
    a softmax over the keys, and the weighted sum of v, all in float32."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(q.shape[-1]))
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)
    return out.contiguous()


def _rows(t: torch.Tensor) -> torch.Tensor:
    """t as the kernel reads it: [H, D] contiguous inside a row, the batch
    stride N rows, rows 16-byte aligned. A packed-qkv slice and its window
    fold pass as they are; anything else is copied."""
    _, n, h, d = t.shape
    ok = (
        t.stride(3) == 1 and t.stride(2) == d and t.stride(1) >= h * d
        and t.stride(0) == n * t.stride(1) and t.stride(1) % 4 == 0
        and t.data_ptr() % 16 == 0
    )
    return t if ok else t.contiguous()


def attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Flash-attention kernel wrapper: one launch (csrc/flash_attn.cu)."""
    _check(q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"attention: {name}: expected a CUDA tensor, got {t.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError(
            "attention: the flash-attention kernel has no backward yet "
            "(ROADMAP.md Queue 2); run under torch.no_grad() or on the CPU"
        )
    b, n, h, d = q.shape
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(
            f"attention kernel takes a head width of {FLASH_HEAD_DIMS}, got D={d}"
        )
    out = torch.empty((b, n, h, d), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    if b * h * ((n + 63) // 64) >= 2**31:
        raise ValueError(f"attention kernel takes < 2^31 blocks, got {tuple(q.shape)}")
    q, k, v = _rows(q), _rows(k), _rows(v)
    _kernels.FLASH_ATTN.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, n, h, d,
        q.stride(1), k.stride(1), v.stride(1), *_kernels.stream_args(q),
    )
    return out
