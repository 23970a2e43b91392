"""PointTransformerV3, the flat model (counterpart of
pointcloud_bridge_tpu/models/ptv3.py): PreLN blocks of multi-head attention
with a learned xyz positional encoding added before the qkv projection, and
a GEGLU feed-forward; LayerNorm and a head with BatchNorm over B*N. With
``window_size > 0`` the points are sorted along a Morton curve and attention
runs inside fixed windows of the sorted axis.

Layers are named after the flax modules (``patch_embed``, ``block0.attn.qkv``,
``block0.mlp.geglu.proj``, ``head_bn``), a Dense weight stored as [out, in],
so ``utils/weights.py`` maps the JAX variables by path. Every attention call
goes through ``ops.attention``, an autograd Function: the flash-attention
kernels on the card, forward and backward, and their plain versions on the
CPU. In train mode the three dropouts a block (after the attention's output
projection, and twice in the feed-forward) and the head's draw from the
generator that the trainer sets.

The production options are ported for a single device:
  - ``compute_dtype`` (for example "bfloat16") runs the wide Dense layers in
    that type, as flax's ``Dense(dtype=...)``: input and weight cast, output
    in it; the residual stream, the LayerNorms and the head stay float32.
  - ``stream_dtype`` makes the residual stream itself that type: x and the
    positional encoding enter it with one cast after ``patch_norm`` and
    leave it with ``norm`` on ``x.float()``; every Dense of a block computes
    in it, and a block's LayerNorms take their statistics in float32, in
    the form E[(x - mu)^2], and give the stream's type.
  - ``remat`` recomputes each block in the backward
    (``torch.utils.checkpoint``): the same forward, gradients and dropout
    masks as without it (the block's Dropout generators are rewound for the
    recompute, see :func:`run_block`).
  - ``num_experts`` > 0 makes every ``moe_every``-th block's feed-forward a
    Mixture of Experts (models/moe.py): the registry's ``ptv3_moe``.
  The parameters stay float32 in every option, so checkpoints interchange
  with the float32 model; casts are explicit where flax casts (no autocast,
  whose cast points differ). In bfloat16 attention takes the bf16 kernels.
``sp_axis`` and ``axis_name`` (a device mesh) are accepted by name and raise
NotImplementedError unless left at their default.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import attention
from .common import BatchNorm, Dense, Dropout
from .moe import MoEFeedForward

LN_EPS = 1e-6  # every LayerNorm of the family (flax's default; torch's is 1e-5)


def only_defaults(owner: str, **args) -> None:
    """Raise unless every unported argument, given as name=(value, default),
    was left at its default."""
    for name, (value, default) in args.items():
        if value != default:
            raise NotImplementedError(
                f"{owner}: {name}={value!r} is not ported to PyTorch yet "
                f"(only {name}={default!r}); ROADMAP.md Queue 1 lists what comes next"
            )


def torch_dtype(name: Union[str, torch.dtype, None]) -> Optional[torch.dtype]:
    """A dtype given by name ("bfloat16", as the configs write it) or as
    itself; None stays None."""
    if name is None or isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise ValueError(f"unknown floating-point dtype {name!r}")
    return dt


class LayerNorm(nn.LayerNorm):
    """LayerNorm whose output is ``dtype`` (a block's in a half-precision
    stream): the statistics and the affine map in float32 from the input's
    values, then one cast, as flax's ``LayerNorm(dtype=...,
    use_fast_variance=False)``. Without ``dtype`` it is ``nn.LayerNorm``.
    Written out, not ``F.layer_norm`` of the float32 values: on the CPU that
    folds the mean into the affine map, which at a mean far from 0 rounds
    about three times as far from the exact value and parts from flax by a
    bf16 spacing (``test_stream_layer_norm_takes_float32_statistics``)."""

    def __init__(self, dim: int, eps: float = LN_EPS, dtype: Optional[torch.dtype] = None):
        super().__init__(dim, eps=eps)
        self.out_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.out_dtype is None:
            return super().forward(x)
        x = x.float()
        mean = x.mean(dim=-1, keepdim=True)
        y = x - mean
        var = (y * y).mean(dim=-1, keepdim=True)
        return (y * (torch.rsqrt(var + self.eps) * self.weight) + self.bias).to(self.out_dtype)


def widen(x: torch.Tensor) -> torch.Tensor:
    """x in float32 where it is in a half type (bfloat16, float16), where
    flax casts to float32 on leaving the stream; float32 and float64 pass."""
    return x.float() if x.dtype in (torch.bfloat16, torch.float16) else x


def run_block(block: nn.Module, x: torch.Tensor, pos: Optional[torch.Tensor],
              remat: bool) -> torch.Tensor:
    """block(x, pos), recomputed in the backward where ``remat`` and autograd
    records (``torch.utils.checkpoint``, non-reentrant). The checkpoint
    restores torch's default CPU and CUDA generators for the recompute but
    not the explicit generators the trainer gives the Dropouts: their states
    are saved here before the forward, set back for the recompute and
    restored after it, so that the recompute draws the forward's masks and
    leaves each generator where the backward found it."""
    if not (remat and torch.is_grad_enabled()):
        return block(x, pos)
    gens = {id(m.generator): m.generator for m in block.modules()
            if isinstance(m, Dropout) and m.generator is not None}
    saved = [(gen, gen.get_state()) for gen in gens.values()]
    calls = []

    def run(x, pos):
        if not calls:  # the forward
            calls.append(1)
            return block(x, pos)
        now = [(gen, gen.get_state()) for gen, _ in saved]
        for gen, state in saved:
            gen.set_state(state)
        try:
            return block(x, pos)
        finally:
            for gen, state in now:
                gen.set_state(state)

    return checkpoint(run, x, pos, use_reentrant=False, preserve_rng_state=True)


def morton_code(xyz: torch.Tensor, bits: int = 10) -> torch.Tensor:
    """Z-order curve key of [B, N, 3] -> [B, N] int64 (ptv3.py:26-43), equal
    to the JAX package's uint32 keys value for value. Each cloud is min-max
    normalised, an axis of zero extent goes to 0, and the grid coordinate is
    the truncated ``q * (2**bits - 1)``. 3 * bits <= 30 bits are used."""
    mn = xyz.amin(dim=1, keepdim=True)
    mx = xyz.amax(dim=1, keepdim=True)
    q = (xyz - mn) / torch.clamp(mx - mn, min=1e-9)
    grid = (q * ((1 << bits) - 1)).to(torch.int64)

    def spread(v):
        # interleave the bits with two zero gaps (bits <= 10)
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    x, y, z = grid.unbind(-1)
    return spread(x) | (spread(y) << 1) | (spread(z) << 2)


def serialize(xyz: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(order, inv_order), each [B, N] int64: the stable sort of the Morton
    keys (equal keys keep their input order, as ``jnp.argsort`` does; keys
    tie often, and the order decides which points share a window) and the
    permutation that undoes it."""
    order = torch.argsort(morton_code(xyz), dim=1, stable=True)
    return order, torch.argsort(order, dim=1)


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, C] with its rows permuted a cloud by idx [B, N]."""
    return torch.gather(x, 1, idx.unsqueeze(-1).expand(-1, -1, x.shape[-1]))


def input_channels(xyz: torch.Tensor, features: Optional[torch.Tensor],
                   d_in: int) -> torch.Tensor:
    """xyz and the features side by side, zero-padded or cut to d_in
    channels (ptv3.py:358-368)."""
    x = xyz if features is None else torch.cat([xyz, features], dim=-1)
    d = x.shape[-1]
    if d < d_in:
        x = F.pad(x, (0, d_in - d))
    return x[..., :d_in]


class GEGLU(nn.Module):
    """``a * gelu(gate)`` of one projection to 2 * dim_out, ``a`` its first
    half; the GELU is the tanh approximation, flax's default
    (ptv3.py:46-54). ``dtype`` is the projection's compute type; in a half
    type the GELU computes in float32 and rounds once, as XLA fuses it."""

    def __init__(self, dim_in: int, dim_out: int,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.proj = Dense(dim_in, dim_out * 2, generator=generator, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, gate = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    """GEGLU to hidden_dim, dropout, a projection back to dim, dropout
    (ptv3.py:57-68)."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.geglu = GEGLU(dim, hidden_dim, generator, dtype)
        self.drop = Dropout(dropout)
        self.out = Dense(hidden_dim, dim, generator=generator, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.drop(self.out(self.drop(self.geglu(x))))


class PointAttention(nn.Module):
    """Multi-head self-attention over the points of a cloud, or inside
    windows of ``window_size`` consecutive points where that divides N
    (ptv3.py:175-219). The positional encoding is added to the input of the
    qkv projection only. q, k and v are slices of the one packed projection,
    and a window fold is a reshape of them: the kernel reads both in place.
    A cloud of fewer points than a window is attended globally, and one
    window is global attention, so the pooled model's levels at or below
    ``window_size`` need no switch. ``attn_drop`` is accepted and unused, as
    in the JAX module. ``dtype`` is the compute type of both projections, and
    so of q, k, v and the attention."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 attn_drop: float = 0.0, proj_drop: float = 0.0, window_size: int = 0,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"PointAttention: dim {dim} not divisible by {num_heads} heads")
        self.num_heads = num_heads
        self.window_size = window_size
        self.qkv = Dense(dim, dim * 3, bias=qkv_bias, generator=generator, dtype=dtype)
        self.proj = Dense(dim, dim, generator=generator, dtype=dtype)
        self.proj_drop = Dropout(proj_drop)

    def forward(self, x: torch.Tensor,
                pos_encoding: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, n, c = x.shape
        h, w = self.num_heads, self.window_size
        if pos_encoding is not None:
            x = x + pos_encoding
        q, k, v = self.qkv(x).reshape(b, n, 3, h, c // h).unbind(2)  # [B, N, H, D] each
        if w and n % w == 0:
            q, k, v = (t.reshape(b * (n // w), w, h, c // h) for t in (q, k, v))
        out = attention(q, k, v).reshape(b, n, c)
        return self.proj_drop(self.proj(out))


class PointTransformerBlock(nn.Module):
    """x + attn(norm1(x), pos), then x + mlp(norm2(x)) (ptv3.py:222-289).
    The Dense layers compute in ``stream_dtype`` where it is set, else in
    ``dtype``; with ``stream_dtype`` the LayerNorms give that type. With
    ``num_experts`` > 0 the feed-forward is a Mixture of Experts, ``moe_mlp``
    (models/moe.py), in place of the dense ``mlp``."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop: float = 0.0, attn_drop: float = 0.0,
                 window_size: int = 0, sp_axis: Optional[str] = None,
                 dtype: Union[str, torch.dtype, None] = None, num_experts: int = 0,
                 moe_top_k: int = 2, moe_capacity_factor: float = 1.25,
                 stream_dtype: Union[str, torch.dtype, None] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        only_defaults("PointTransformerBlock", sp_axis=(sp_axis, None))
        sdt = torch_dtype(stream_dtype)
        cdt = sdt if sdt is not None else torch_dtype(dtype)
        hidden = int(dim * mlp_ratio)
        self.norm1 = LayerNorm(dim, dtype=sdt)
        self.attn = PointAttention(dim, num_heads, qkv_bias, attn_drop, drop, window_size,
                                   generator, cdt)
        self.norm2 = LayerNorm(dim, dtype=sdt)
        if num_experts > 0:
            self.moe_mlp = MoEFeedForward(num_experts, hidden, dim, moe_top_k,
                                          moe_capacity_factor, dropout=drop, dtype=cdt,
                                          generator=generator)
        else:
            self.mlp = FeedForward(dim, hidden, drop, generator, cdt)

    def forward(self, x: torch.Tensor,
                pos_encoding: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), pos_encoding)
        mlp = self.moe_mlp if hasattr(self, "moe_mlp") else self.mlp
        return x + mlp(self.norm2(x))


class SegmentationHead(nn.Module):
    """The family's head (ptv3.py:452-460): ``norm``, ``head_fc1`` to 256,
    ``head_bn`` over B*N, ReLU, dropout, ``head_fc2``. A model *is* this head
    with its trunk added, which keeps the flax names flat."""

    def __init__(self, dim: int, num_classes: int, head_drop_rate: float,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.head_fc1 = Dense(dim, 256, generator=generator)
        self.head_bn = BatchNorm(256)
        self.head_drop = Dropout(head_drop_rate)
        self.head_fc2 = Dense(256, num_classes, generator=generator)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.head_bn(self.head_fc1(self.norm(widen(x)))))
        return self.head_fc2(self.head_drop(x))


class PointTransformerV3(SegmentationHead):
    """forward(xyz [B, N, 3], features [B, N, C] or None) -> logits
    [B, N, num_classes], float32 (ptv3.py:292-468). On CUDA it expects full
    float32 matmuls, as the other models do. Block i is MoE where
    ``num_experts`` > 0 and i % moe_every == moe_every - 1."""

    def __init__(
        self,
        num_classes: int = 5,
        d_in: int = 6,
        embed_dim: int = 384,
        depth: int = 8,
        num_heads: int = 2,
        mlp_ratio: float = 4.0,
        qkv_bias: bool = True,
        drop_rate: float = 0.1,
        attn_drop_rate: float = 0.1,
        head_drop_rate: float = 0.5,
        window_size: int = 0,
        axis_name: Optional[str] = None,
        sp_axis: Optional[str] = None,
        compute_dtype: Optional[str] = None,
        num_experts: int = 0,
        moe_top_k: int = 2,
        moe_capacity_factor: float = 1.25,
        moe_every: int = 2,
        stream_dtype: Optional[str] = None,
        remat: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(embed_dim, num_classes, head_drop_rate, generator)
        only_defaults("PointTransformerV3", axis_name=(axis_name, None),
                      sp_axis=(sp_axis, None))
        g = generator
        cdt = torch_dtype(compute_dtype)
        self.stream_dtype = torch_dtype(stream_dtype)
        self.remat = remat
        self.d_in = d_in
        self.depth = depth
        self.window_size = window_size
        self.patch_embed = Dense(d_in, embed_dim, generator=g, dtype=cdt)
        self.patch_norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.pos_embed = Dense(3, embed_dim, generator=g, dtype=cdt)
        for i in range(depth):
            moe_here = num_experts > 0 and i % moe_every == moe_every - 1
            setattr(self, f"block{i}", PointTransformerBlock(
                embed_dim, num_heads, mlp_ratio, qkv_bias, drop_rate, attn_drop_rate,
                window_size, dtype=cdt, num_experts=num_experts if moe_here else 0,
                moe_top_k=moe_top_k, moe_capacity_factor=moe_capacity_factor,
                stream_dtype=self.stream_dtype, generator=g))

    def forward(self, xyz: torch.Tensor,
                features: Optional[torch.Tensor]) -> torch.Tensor:
        x = input_channels(xyz, features, self.d_in)
        inv_order = None
        if self.window_size:
            # serialise: windows of the sorted axis are spatially compact
            order, inv_order = serialize(xyz)
            x = take_rows(x, order)
            # the first 3 channels of x are xyz, sorted with it
            xyz = x[..., :3] if self.d_in >= 3 else take_rows(xyz, order)
        x = self.patch_norm(widen(self.patch_embed(x)))
        pos = self.pos_embed(xyz)
        if self.stream_dtype is not None:  # enter the stream
            x, pos = x.to(self.stream_dtype), pos.to(self.stream_dtype)
        for i in range(self.depth):
            x = run_block(getattr(self, f"block{i}"), x, pos, self.remat)
        logits = self.head(x)
        return logits if inv_order is None else take_rows(logits, inv_order)
