"""Sequence-parallel ring attention over a mesh axis (counterpart of
pointcloud_bridge_tpu/parallel/ring.py).

The N point axis of a cloud is split over the P ranks of the axis; global
attention over the whole cloud runs without any rank holding all its keys.
K and V travel once around the ring (:func:`~..utils.collectives.rotate`,
one send and one receive a rank and step), and each step is one call of
the flash-attention kernels over a K/V block of N/P keys:

- forward: step j gives the block's output ``o_j`` and the log-sum-exp
  ``lse_j`` of its scaled scores (ops/attention.py::attention_cuda with
  ``need_lse``, K6); the blocks combine exactly as
  ``lse = logsumexp_j lse_j`` and ``o = sum_j exp(lse_j - lse) o_j``;
- backward: K and V go round again. With the global ``o`` and ``lse``, a
  block's probabilities are ``exp(S_j - lse)`` and ``delta = rowsum(do o)``
  is the whole row's, so the dq kernel gives the block's exact share of dq
  and the dk/dv kernel the block's dk and dv (K6b). Those travel with the
  block and arrive home after P hops.

The ring computes in float32 whatever the stream's type, as the JAX ring
does (ring.py:42-62), and returns q's type. On CPU tensors each step is
the plain attention and its plain backward (ops/attention.py), so the CPU
tests run this Function's schedule; :func:`ring_attention_plain` is the
JAX algorithm itself, an online softmax over einsums with K and V rotated
by the autograd :func:`~..utils.collectives.ppermute`.
"""

from __future__ import annotations

import math

import torch

from ..ops.attention import (
    attention_backward_dkv_cuda,
    attention_backward_dq_cuda,
    attention_backward_plain,
    attention_cuda,
    _forward_plain,
)
from ..utils.collectives import axis_group, ppermute, rotate


def _block_forward(q, k, v):
    """(o [B, N, H, D], lse [B, H, N]) of attention over one K/V block."""
    if q.is_cuda:
        return attention_cuda(q, k, v, need_lse=True)
    out, scores = _forward_plain(q, k, v)
    return out, torch.logsumexp(scores, dim=-1)


def _block_backward(q, k, v, out, lse, grad_out):
    """(dq share, dk, dv) of one K/V block, from the whole row's out, lse."""
    if q.is_cuda:
        dq, delta = attention_backward_dq_cuda(q, k, v, out, lse, grad_out)
        return (dq, *attention_backward_dkv_cuda(q, k, v, lse, delta, grad_out))
    return attention_backward_plain(q, k, v, out, lse, grad_out)


def ring_forward(q, k, v, group):
    """The ring's forward on float32 contiguous [B, N/P, H, D] shards ->
    (this rank's output [B, N/P, H, D], its rows' log-sum-exp [B, H, N/P]
    over the whole N), outside autograd."""
    p = torch.distributed.get_world_size(group)
    kv = torch.stack([k, v])
    outs, lses = [], []
    for step in range(p):
        o, lse = _block_forward(q, kv[0], kv[1])
        outs.append(o)
        lses.append(lse)
        if step < p - 1:
            kv = rotate(kv, group)
    lse_j = torch.stack(lses)  # [P, B, H, N]
    lse = torch.logsumexp(lse_j, dim=0)
    w = torch.exp(lse_j - lse).permute(0, 1, 3, 2).unsqueeze(-1)  # [P, B, N, H, 1]
    return (torch.stack(outs) * w).sum(0), lse


class RingAttention(torch.autograd.Function):
    """ring_attention() on float32 contiguous [B, N/P, H, D] shards."""

    @staticmethod
    def forward(ctx, q, k, v, group):
        out, lse = ring_forward(q, k, v, group)
        ctx.group = group
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        q, k, v, out, lse = ctx.saved_tensors
        group = ctx.group
        p = torch.distributed.get_world_size(group)
        grad_out = grad_out.contiguous()
        dq = torch.zeros_like(q)
        # K, V and the block's dk, dv travel together
        block = torch.stack([k, v, torch.zeros_like(k), torch.zeros_like(v)])
        for step in range(p):
            dq_j, dk_j, dv_j = _block_backward(q, block[0], block[1], out, lse, grad_out)
            dq += dq_j
            block[2] += dk_j
            block[3] += dv_j
            # after the last step one more hop brings dk, dv home
            block = rotate(block if step < p - 1 else block[2:], group)
        return dq, block[0], block[1], None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis_name) -> torch.Tensor:
    """Global attention over an N axis split over the ranks of
    ``axis_name``: q, k, v the [B, N/P, H, D] local shards (the JAX layout,
    any strides) -> this rank's [B, N/P, H, D] slice of the whole cloud's
    attention output, in q's type. Softmax scale 1/sqrt(D). Every rank of
    the axis must call it, in the forward and in the backward."""
    group = axis_group(axis_name)
    qf, kf, vf = (t.float().contiguous() for t in (q, k, v))
    return RingAttention.apply(qf, kf, vf, group).to(q.dtype)


def ring_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         axis_name) -> torch.Tensor:
    """The plain version: the JAX ring (ring.py:40-71) in PyTorch, an
    online softmax over einsums in float32, K and V rotated by the autograd
    ``ppermute``, differentiable by autograd."""
    p = torch.distributed.get_world_size(axis_group(axis_name))
    d = q.shape[-1]
    qf = q.permute(0, 2, 1, 3).float() * (d ** -0.5)
    kc, vc = k.permute(0, 2, 1, 3).float(), v.permute(0, 2, 1, 3).float()
    b, h, nl, _ = qf.shape
    m = torch.full((b, h, nl), -math.inf, dtype=torch.float32, device=q.device)
    den = torch.zeros((b, h, nl), dtype=torch.float32, device=q.device)
    num = torch.zeros((b, h, nl, d), dtype=torch.float32, device=q.device)
    for step in range(p):
        s = torch.einsum("bhnd,bhmd->bhnm", qf, kc)
        m_new = torch.maximum(m, s.amax(-1))
        c = torch.exp(m - m_new)
        w = torch.exp(s - m_new.unsqueeze(-1))
        num = num * c.unsqueeze(-1) + torch.einsum("bhnm,bhmd->bhnd", w, vc)
        den = den * c + w.sum(-1)
        m = m_new
        if step < p - 1:
            kc, vc = ppermute(kc, axis_name), ppermute(vc, axis_name)
    return (num / den.unsqueeze(-1)).permute(0, 2, 1, 3).to(q.dtype)
