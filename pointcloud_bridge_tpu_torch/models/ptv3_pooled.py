"""Hierarchical serialized PTv3 (counterpart of
pointcloud_bridge_tpu/models/ptv3_pooled.py): an encoder-decoder over the
Morton-sorted point axis. The points are sorted once; between the encoder
levels ``stride`` consecutive points pool into one (a projection, a max over
the segment, a LayerNorm), and the decoder broadcasts each parent back to its
children and adds a projection of the encoder's skip. A level runs windowed
attention while its point count exceeds ``window_size`` and global attention
from there down. Blocks, Morton keys and head are the flat model's
(models/ptv3.py), so every attention call goes through ``ops.attention``.

Layers carry the flax names (``enc1_block0.mlp.geglu.proj``, ``pool0.proj``,
``unpool0.proj_skip``, ``enc2_pos``, ``head_bn``). ``compute_dtype``,
``stream_dtype`` and ``remat`` act as in the flat model (models/ptv3.py): a
level's x and positional encoding enter the stream before its blocks and
leave it after them, and the pooling and unpooling projections compute in
``compute_dtype`` with their LayerNorms in float32
(ptv3_pooled.py:59-98, 243-307). ``axis_name`` syncs every BatchNorm over that mesh axis (``sync_batchnorms``).

``sp_axis`` is sequence parallelism in the whole-input contract of the
windowed flat model, a level at a time (ptv3_pooled.py:31-41, 198-322):
the inputs arrive whole on every rank and are sorted on each. A level whose
slice of the sorted axis holds complete windows runs SHARDED (this rank's
contiguous slice; a slice's children pool to exactly that slice's
parents); any other level runs FULL, the same on every rank. One gather
(sharded to full) or one slice (full to sharded) moves between levels, the
per-level xyz stays whole on every rank, and the logits are gathered once
before the inverse permutation. Set ``axis_name`` to the same axis for
train-mode BatchNorm.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..utils.collectives import all_gather, axis_size, sp_shard_slice
from .common import Dense, sync_batchnorms
from .ptv3 import (
    LN_EPS,
    PointTransformerBlock,
    SegmentationHead,
    input_channels,
    run_block,
    serialize,
    take_rows,
    torch_dtype,
    widen,
)


class SerializedPool(nn.Module):
    """[B, N, C] -> [B, N/s, dim_out]: projection, then the max over each
    segment of s consecutive points, then LayerNorm; xyz pools by the
    segment mean (ptv3_pooled.py:59-80)."""

    def __init__(self, stride: int, dim_in: int, dim_out: int,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.stride = stride
        self.proj = Dense(dim_in, dim_out, generator=generator, dtype=dtype)
        self.norm = nn.LayerNorm(dim_out, eps=LN_EPS)

    def forward(self, x: torch.Tensor,
                xyz: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        b, n, _ = x.shape
        g, s = n // self.stride, self.stride
        h = self.proj(x)
        h = h.reshape(b, g, s, h.shape[-1]).amax(dim=2)
        return self.norm(widen(h)), xyz.reshape(b, g, s, 3).mean(dim=2)


class SerializedUnpool(nn.Module):
    """The inverse of SerializedPool: each parent row goes back to its s
    children, and ``proj_up`` of it is added to ``proj_skip`` of the
    encoder's skip, then LayerNorm (ptv3_pooled.py:83-98). The projection is
    taken before the repeat: it acts a row, so the rows are the same and a
    quarter of them are computed."""

    def __init__(self, stride: int, dim_in: int, dim_out: int,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.stride = stride
        self.proj_up = Dense(dim_in, dim_out, generator=generator, dtype=dtype)
        self.proj_skip = Dense(dim_out, dim_out, generator=generator, dtype=dtype)
        self.norm = nn.LayerNorm(dim_out, eps=LN_EPS)

    def forward(self, x_coarse: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        up = self.proj_up(x_coarse).repeat_interleave(self.stride, dim=1)
        return self.norm(widen(up + self.proj_skip(skip)))


class PointTransformerV3Pooled(SegmentationHead):
    """forward(xyz [B, N, 3], features [B, N, C] or None) -> logits
    [B, N, num_classes], float32 (ptv3_pooled.py:101-323). ``dims`` and
    ``enc_depths`` have an entry a level, ``strides`` and ``dec_depths`` one
    fewer; N must be a multiple of the product of the strides, and a windowed
    level's point count a multiple of ``window_size``. Level i has
    ``max(1, dims[i] // head_dim)`` heads."""

    def __init__(
        self,
        num_classes: int = 5,
        d_in: int = 6,
        dims: Sequence[int] = (64, 128, 256),
        enc_depths: Sequence[int] = (2, 2, 2),
        dec_depths: Sequence[int] = (1, 1),
        strides: Sequence[int] = (4, 4),
        head_dim: int = 32,
        mlp_ratio: float = 4.0,
        qkv_bias: bool = True,
        drop_rate: float = 0.1,
        attn_drop_rate: float = 0.1,
        head_drop_rate: float = 0.5,
        window_size: int = 1024,
        axis_name: Optional[str] = None,
        sp_axis: Optional[str] = None,
        compute_dtype: Optional[str] = None,
        stream_dtype: Optional[str] = None,
        remat: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        dims, strides = tuple(dims), tuple(strides)
        super().__init__(dims[0], num_classes, head_drop_rate, generator)
        self.sp_axis = sp_axis
        cdt = torch_dtype(compute_dtype)
        self.stream_dtype = torch_dtype(stream_dtype)
        self.remat = remat
        if not (len(dims) == len(enc_depths) and len(strides) == len(dims) - 1
                and len(dec_depths) == len(dims) - 1):
            raise ValueError("dims/enc_depths must share a length L and strides/dec_depths "
                             "have L-1 entries")
        g = generator
        self.d_in = d_in
        self.dims = dims
        self.enc_depths = tuple(enc_depths)
        self.dec_depths = tuple(dec_depths)
        self.strides = strides
        self.head_dim = head_dim
        self.window_size = window_size
        self.patch_embed = Dense(d_in, dims[0], generator=g, dtype=cdt)
        self.patch_norm = nn.LayerNorm(dims[0], eps=LN_EPS)

        def add_blocks(tag: str, lv: int, count: int) -> None:
            setattr(self, f"{tag}_pos", Dense(3, dims[lv], generator=g, dtype=cdt))
            for i in range(count):
                setattr(self, f"{tag}_block{i}", PointTransformerBlock(
                    dims[lv], max(1, dims[lv] // head_dim), mlp_ratio, qkv_bias,
                    drop_rate, attn_drop_rate, window_size, dtype=cdt,
                    stream_dtype=self.stream_dtype, generator=g))

        for lv in range(len(dims)):
            add_blocks(f"enc{lv}", lv, self.enc_depths[lv])
            if lv < len(dims) - 1:
                setattr(self, f"pool{lv}",
                        SerializedPool(strides[lv], dims[lv], dims[lv + 1], g, cdt))
        for lv in range(len(dims) - 2, -1, -1):
            setattr(self, f"unpool{lv}",
                    SerializedUnpool(strides[lv], dims[lv + 1], dims[lv], g, cdt))
            add_blocks(f"dec{lv}", lv, self.dec_depths[lv])
        sync_batchnorms(self, axis_name)

    def _level_window(self, level_n: int) -> int:
        """The window of a level of level_n points: ``window_size`` while the
        level exceeds it, else 0 (global attention over the small level).
        The blocks come to the same split on their own; this refuses a level
        that its windows do not divide, which they would attend globally."""
        w = self.window_size
        if w and level_n > w:
            if level_n % w:
                raise ValueError(
                    f"level point count {level_n} not divisible by window_size {w}")
            return w
        return 0

    def _run_blocks(self, x: torch.Tensor, xyz: torch.Tensor, tag: str,
                    count: int) -> torch.Tensor:
        self._level_window(x.shape[1])
        pos = getattr(self, f"{tag}_pos")(xyz)
        sdt = self.stream_dtype
        if sdt is not None:  # the level enters the stream
            x, pos = x.to(sdt), pos.to(sdt)
        for i in range(count):
            x = run_block(getattr(self, f"{tag}_block{i}"), x, pos, self.remat)
        return widen(x)

    def forward(self, xyz: torch.Tensor,
                features: Optional[torch.Tensor]) -> torch.Tensor:
        n = xyz.shape[1]
        total_stride = 1
        for s in self.strides:
            total_stride *= s
        if n % total_stride:
            raise ValueError(f"N={n} must be divisible by prod(strides)={total_stride}")

        # serialise once; every level inherits the order (a segment of a
        # Morton order is a compact cell at every scale)
        order, inv_order = serialize(xyz)
        x = take_rows(input_channels(xyz, features, self.d_in), order)
        # the first 3 channels of x are xyz, sorted with it
        xyz_lv = [x[..., :3] if self.d_in >= 3 else take_rows(xyz, order)]
        if self.sp_axis:
            # every level's xyz, whole on every rank (a sharded pool's means
            # are its slice's alone): the segment means of its children
            for lv, s in enumerate(self.strides):
                b, m, _ = xyz_lv[lv].shape
                xyz_lv.append(xyz_lv[lv].reshape(b, m // s, s, 3).mean(dim=2))
        levels = len(self.dims)
        modes = self._sp_modes(n)
        if modes[0] == "sharded":  # embed this rank's slice alone
            x = sp_shard_slice(x, self.sp_axis)

        x = self.patch_norm(widen(self.patch_embed(x)))
        skips = []
        for lv in range(levels):
            x = self._run_blocks(x, self._level_xyz(xyz_lv[lv], modes[lv]), f"enc{lv}",
                                 self.enc_depths[lv])
            if lv < levels - 1:
                skips.append(x)
                if modes[lv] == "sharded" and x.shape[1] % self.strides[lv]:
                    raise ValueError(f"sp pooling: per-shard count {x.shape[1]} not "
                                     f"divisible by stride {self.strides[lv]}")
                x, xyz_coarse = getattr(self, f"pool{lv}")(
                    x, self._level_xyz(xyz_lv[lv], modes[lv]))
                if not self.sp_axis:
                    xyz_lv.append(xyz_coarse)
                x = self._to_mode(x, modes[lv], modes[lv + 1])
        for lv in range(levels - 2, -1, -1):
            # a rank's children pool to exactly its parents (contiguous
            # nesting): the child level's slice of parents is the coarse
            # level's slice
            x = self._to_mode(x, modes[lv + 1], modes[lv])
            x = getattr(self, f"unpool{lv}")(x, skips[lv])
            x = self._run_blocks(x, self._level_xyz(xyz_lv[lv], modes[lv]), f"dec{lv}",
                                 self.dec_depths[lv])
        logits = self.head(x)
        if modes[0] == "sharded":
            logits = all_gather(logits, self.sp_axis)
        return take_rows(logits, inv_order)

    def _sp_modes(self, n: int) -> list:
        """Each level's state: "single" without ``sp_axis``; "sharded" where
        the level's slice of the sorted axis holds complete windows; "full"
        elsewhere (the small coarse levels, attended globally)."""
        if not self.sp_axis:
            return ["single"] * len(self.dims)
        p = axis_size(self.sp_axis)
        modes = []
        for lv in range(len(self.dims)):
            win = self._level_window(n)
            modes.append("sharded" if win and n % p == 0 and (n // p) % win == 0 else "full")
            if lv < len(self.strides):
                n //= self.strides[lv]
        return modes

    def _to_mode(self, t: torch.Tensor, cur: str, want: str) -> torch.Tensor:
        if cur == "full" and want == "sharded":
            return sp_shard_slice(t, self.sp_axis)
        if cur == "sharded" and want == "full":
            return all_gather(t, self.sp_axis)
        return t

    def _level_xyz(self, xyz: torch.Tensor, mode: str) -> torch.Tensor:
        return sp_shard_slice(xyz, self.sp_axis) if mode == "sharded" else xyz
