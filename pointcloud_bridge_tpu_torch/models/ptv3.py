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

Only the dense, single-device, float32 model is ported, for serving and for
training. The JAX classes'
other arguments (``sp_axis``, ``axis_name``, ``compute_dtype``,
``stream_dtype``, ``remat``, ``num_experts`` and the ``moe_*`` arguments) are
accepted by name and raise NotImplementedError unless left at their default.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention
from .common import BatchNorm, Dense, Dropout

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
    (ptv3.py:46-54)."""

    def __init__(self, dim_in: int, dim_out: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.proj = Dense(dim_in, dim_out * 2, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, gate = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    """GEGLU to hidden_dim, dropout, a projection back to dim, dropout
    (ptv3.py:57-68)."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.geglu = GEGLU(dim, hidden_dim, generator)
        self.drop = Dropout(dropout)
        self.out = Dense(hidden_dim, dim, generator=generator)

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
    in the JAX module."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 attn_drop: float = 0.0, proj_drop: float = 0.0, window_size: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"PointAttention: dim {dim} not divisible by {num_heads} heads")
        self.num_heads = num_heads
        self.window_size = window_size
        self.qkv = Dense(dim, dim * 3, bias=qkv_bias, generator=generator)
        self.proj = Dense(dim, dim, generator=generator)
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
    """x + attn(norm1(x), pos), then x + mlp(norm2(x)) (ptv3.py:222-289);
    the feed-forward is the dense one."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop: float = 0.0, attn_drop: float = 0.0,
                 window_size: int = 0, sp_axis: Optional[str] = None,
                 dtype: Optional[str] = None, num_experts: int = 0, moe_top_k: int = 2,
                 moe_capacity_factor: float = 1.25, stream_dtype: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        only_defaults("PointTransformerBlock", sp_axis=(sp_axis, None), dtype=(dtype, None),
                      num_experts=(num_experts, 0), moe_top_k=(moe_top_k, 2),
                      moe_capacity_factor=(moe_capacity_factor, 1.25),
                      stream_dtype=(stream_dtype, None))
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = PointAttention(dim, num_heads, qkv_bias, attn_drop, drop, window_size,
                                   generator)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = FeedForward(dim, int(dim * mlp_ratio), drop, generator)

    def forward(self, x: torch.Tensor,
                pos_encoding: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), pos_encoding)
        return x + self.mlp(self.norm2(x))


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
        x = F.relu(self.head_bn(self.head_fc1(self.norm(x))))
        return self.head_fc2(self.head_drop(x))


class PointTransformerV3(SegmentationHead):
    """forward(xyz [B, N, 3], features [B, N, C] or None) -> logits
    [B, N, num_classes], float32 (ptv3.py:292-468). On CUDA it expects full
    float32 matmuls, as the other models do."""

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
                      sp_axis=(sp_axis, None), compute_dtype=(compute_dtype, None),
                      num_experts=(num_experts, 0), moe_top_k=(moe_top_k, 2),
                      moe_capacity_factor=(moe_capacity_factor, 1.25),
                      moe_every=(moe_every, 2), stream_dtype=(stream_dtype, None),
                      remat=(remat, False))
        g = generator
        self.d_in = d_in
        self.depth = depth
        self.window_size = window_size
        self.patch_embed = Dense(d_in, embed_dim, generator=g)
        self.patch_norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.pos_embed = Dense(3, embed_dim, generator=g)
        for i in range(depth):
            setattr(self, f"block{i}", PointTransformerBlock(
                embed_dim, num_heads, mlp_ratio, qkv_bias, drop_rate, attn_drop_rate,
                window_size, generator=g))

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
        x = self.patch_norm(self.patch_embed(x))
        pos = self.pos_embed(xyz)
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x, pos)
        logits = self.head(x)
        return logits if inv_order is None else take_rows(logits, inv_order)
