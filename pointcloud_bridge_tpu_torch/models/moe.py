"""Mixture-of-Experts feed-forward (counterpart of
pointcloud_bridge_tpu/models/moe.py): the ``moe_mlp`` of every
``moe_every``-th block of ``ptv3_moe``.

The tokens of a [B, N, d] input are routed in groups of S (the largest
divisor of B*N up to 512) with a fixed capacity of C slots an expert and
group. A float32 router (no bias) picks the top_k experts of each token by
iterated argmax (the lowest index on a tie, as ``jnp.argmax``), and the
chosen gates are renormalised to sum to 1. Slots are handed out rank-major,
as GShard does: every token's first choice before any second choice, in
token order within a rank; a choice whose position in its expert is C or
more is dropped (the token still rides the block's residual). Each expert is
the GEGLU feed-forward of the dense block (proj to 2*hidden, a * gelu(gate)
with the tanh GELU, dropout, out) in the block's compute type, and a
token's output is the gate-weighted sum of its kept experts' outputs,
followed by the second dropout.

Dispatch is by index, the JAX package's opt-in path
(``PCB_MOE_DENSE_DISPATCH=0``), which computes the same function as its
default one-hot einsums: a slot table says which token fills each (expert,
slot), and row gathers replace the [G, K*S, E, C] one-hot contractions
(671 MB each in float32 at batch 16 x 4096 with 8 experts and top 2).
Unfilled slots read a zero row. The Switch load-balance loss is computed on
every call and kept, detached, as ``aux_loss``; the single-device trainer
does not add it to the loss, as the JAX single-device step does not (only
the JAX package's expert-parallel step does). Kept with its autograd graph
it would hold that graph, and the router's gradient accumulators in it,
into the next step, where a CUDA graph captured on another stream
(train/loop.py::GraphSteps) cannot take them. ``routing`` keeps the last
call's expert picks and slots, for the tests.

Parameters carry the flax names: the stacked ``experts_proj_kernel`` [E, d,
2h], ``experts_proj_bias`` [E, 2h], ``experts_out_kernel`` [E, h, d] and
``experts_out_bias`` [E, d] as the JAX module stores them, and ``router``, a
Dense whose weight is stored [E, d].
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .common import Dense, Dropout


def _group_size(total: int, max_group: int) -> int:
    """Largest divisor of ``total`` that is <= max_group (moe.py:95)."""
    g = min(max_group, total)
    while total % g:
        g -= 1
    return g


def capacity(tokens: int, experts: int, top_k: int, capacity_factor: float) -> int:
    """Slots an expert takes from a group of ``tokens`` (moe.py:150-151): at
    least 8, rounded up to a multiple of 8, at most top_k * tokens."""
    c = max(8, int(-(-top_k * tokens * capacity_factor // experts)))
    return min(-(-c // 8) * 8, top_k * tokens)


class MoEFeedForward(nn.Module):
    """forward(x [B, N, d]) -> [B, N, d] in x's type (moe.py:103-301)."""

    def __init__(self, num_experts: int, hidden_dim: int, dim: int, top_k: int = 2,
                 capacity_factor: float = 1.25, max_group_size: int = 512,
                 dropout: float = 0.0, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not 1 <= top_k <= num_experts:
            raise ValueError(f"top_k={top_k} must be in [1, num_experts={num_experts}]")
        e, h = num_experts, hidden_dim
        self.num_experts, self.top_k = e, top_k
        self.capacity_factor, self.max_group_size = capacity_factor, max_group_size
        self.dtype = dtype
        self.experts_proj_kernel = nn.Parameter(torch.empty(e, dim, 2 * h))
        self.experts_proj_bias = nn.Parameter(torch.zeros(e, 2 * h))
        self.experts_out_kernel = nn.Parameter(torch.empty(e, h, dim))
        self.experts_out_bias = nn.Parameter(torch.zeros(e, dim))
        with torch.no_grad():  # variance 1 / fan_in, as the JAX initialiser's
            for w, fan_in in ((self.experts_proj_kernel, dim), (self.experts_out_kernel, h)):
                bound = math.sqrt(3.0 / fan_in)
                w.uniform_(-bound, bound, generator=generator)
        self.router = Dense(dim, e, bias=False, generator=generator)  # always float32
        self.drop = Dropout(dropout)
        self.aux_loss: Optional[torch.Tensor] = None
        self.routing: Dict[str, torch.Tensor] = {}

    def route(self, xt: torch.Tensor):
        """Router of one [G, S, d] input -> (sel [G, S, K] expert picks,
        gate [G, S, K] renormalised, probs [G, S, E]), all in float32 but
        sel."""
        probs = torch.softmax(self.router(xt.float()), dim=-1)
        sel, gate = [], []
        masked = probs
        for _ in range(self.top_k):
            idx = masked.argmax(dim=-1)
            sel.append(idx)
            gate.append(masked.gather(-1, idx.unsqueeze(-1)).squeeze(-1))
            masked = masked * (1.0 - F.one_hot(idx, self.num_experts).to(probs.dtype))
        sel = torch.stack(sel, dim=-1)
        gate = torch.stack(gate, dim=-1)
        gate = gate / gate.sum(dim=-1, keepdim=True).clamp(min=1e-9)
        return sel, gate, probs

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        e, k = self.num_experts, self.top_k
        tokens = b * n
        s = _group_size(tokens, self.max_group_size)
        g = tokens // s
        c = capacity(s, e, k, self.capacity_factor)
        cdt = self.dtype or x.dtype
        xt = x.reshape(g, s, d)
        sel, gate, probs = self.route(xt)

        # Switch load-balance loss over the first choices
        f_e = F.one_hot(sel[..., 0], e).float().mean(dim=(0, 1))
        self.aux_loss = (e * (f_e * probs.mean(dim=(0, 1))).sum()).detach()

        # rank-major capacity: choice r * S + i is token i's r-th pick
        choice = sel.transpose(1, 2).reshape(g, k * s)
        onehot = F.one_hot(choice, e)
        pos = (onehot.cumsum(dim=1) - onehot).gather(-1, choice.unsqueeze(-1)).squeeze(-1)
        kept = pos < c
        ec = e * c
        slot = torch.where(kept, choice * c + pos, torch.full_like(choice, ec))
        self.routing = {"sel": sel.detach(), "slot": slot.detach()}

        # the token that fills each (expert, slot); unfilled ones read row S,
        # a zero row. Kept slots are unique; dropped choices go to column EC,
        # which is cut off.
        tok = torch.arange(s, device=x.device).repeat(k).expand(g, -1).contiguous()
        table = torch.full((g, ec + 1), s, dtype=torch.long, device=x.device)
        table.scatter_(1, slot, tok)
        rows = table[:, :ec] + torch.arange(g, device=x.device).unsqueeze(1) * (s + 1)
        xt_pad = torch.cat([xt.to(cdt), xt.new_zeros((g, 1, d), dtype=cdt)], dim=1)
        expert_in = xt_pad.reshape(g * (s + 1), d).index_select(0, rows.reshape(-1))
        expert_in = expert_in.reshape(g, e, c, d)

        h = (torch.einsum("gecd,edh->gech", expert_in, self.experts_proj_kernel.to(cdt))
             + self.experts_proj_bias.to(cdt)[:, None, :])
        a, gt = h.chunk(2, dim=-1)
        h = self.drop(a * F.gelu(gt, approximate="tanh"))
        out = (torch.einsum("gech,ehd->gecd", h, self.experts_out_kernel.to(cdt))
               + self.experts_out_bias.to(cdt)[:, None, :])

        # each choice reads its slot's output (a dropped one the zero row EC)
        # and weighs it by its gate; a token sums its K choices
        out_pad = torch.cat([out.reshape(g, ec, d), out.new_zeros((g, 1, d))], dim=1)
        picks = slot + torch.arange(g, device=x.device).unsqueeze(1) * (ec + 1)
        y = out_pad.reshape(g * (ec + 1), d).index_select(0, picks.reshape(-1))
        gate_flat = gate.transpose(1, 2).reshape(g, k * s)
        y = y.reshape(g, k * s, d) * gate_flat.unsqueeze(-1).to(cdt)
        y = y.reshape(g, k, s, d).sum(dim=1).reshape(b, n, d)
        return self.drop(y.to(x.dtype))


def upcycle_dense_to_moe(dense: Dict[str, torch.Tensor],
                         moe: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Sparse upcycling over state_dicts (moe.py:51): the state_dict of a
    ``ptv3_moe`` model whose every leaf is the dense PTv3's where the dense
    model has it, and whose MoE blocks hold the dense block's feed-forward in
    each expert (its Dense weights transposed into the flax layout); the
    routers keep ``moe``'s weights. With a capacity that drops nothing, the
    renormalised gates sum to 1 over identical experts, so the MoE model
    computes the dense model's function."""
    out = {key: dense.get(key, value) for key, value in moe.items()}
    for key in moe:
        if not key.endswith(".moe_mlp.experts_proj_kernel"):
            continue
        block = key[: -len(".moe_mlp.experts_proj_kernel")]
        e = moe[key].shape[0]
        mlp = {leaf: dense[f"{block}.mlp.{name}"] for leaf, name in (
            ("experts_proj_kernel", "geglu.proj.weight"), ("experts_proj_bias", "geglu.proj.bias"),
            ("experts_out_kernel", "out.weight"), ("experts_out_bias", "out.bias"))}
        for leaf, value in mlp.items():
            value = value.t() if value.dim() == 2 else value
            out[f"{block}.moe_mlp.{leaf}"] = value.expand(e, *value.shape).clone()
    return out
