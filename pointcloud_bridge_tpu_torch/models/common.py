"""Shared building blocks of the PointNet++ models, in PyTorch.

Counterpart of pointcloud_bridge_tpu/models/common.py. The compute is
channel-last like the JAX package: a kernel-size-1 convolution of the
reference is ``F.linear`` over the last axis, BatchNorm normalises over
every axis but the channels, and the max over neighbours is ``torch.amax``.

Parameter names and shapes are the reference torch model's
(``sa1.mlp_convs.0.weight`` [64, 6, 1, 1], ``fp1.mlp_bns.2.running_var``,
``conv1``, ``bn1``, ``conv2``), so ``convert_state_dict`` of the JAX package
maps the port's weights to flax variables unchanged. To keep those names
flat, a set-abstraction or feature-propagation layer *is* a SharedMLP with
its sampling and grouping added, and a segmentation model *is* a SegHead
with its encoder and decoder added.

The Partsize MSG layer (:class:`MultiScaleSetAbstractionMsg`) carries the
reference's ``conv_blocks.{b}.{j}`` and ``bn_blocks.{b}.{j}``, and the first
conv of each branch keeps the reference's input order [features, rel-xyz]
(:class:`FeatFirstConv` rolls it at the call).

The BriStruNet family has no mappable reference torch model, so its layers
(:class:`Dense`, :class:`DenseMLP`, :class:`MultiScaleSetAbstraction`,
:class:`EnhancedFeaturePropagation` and models/attention.py) are named after
the flax modules of the JAX package instead (``sa1.mlp_0.dense_0``,
``fp3.attn_dense0``), with a Dense weight stored as [out, in].

``sp_axis`` (sequence parallelism in the whole-input contract,
parallel/sp.py with ``shard_inputs=False``; models/common.py:81-314 of the
JAX package): the inputs arrive whole on every rank, FPS runs over the
whole cloud on each, and the per-query work (ball query, grouping, shared
MLP, pooling; the fine points of an interpolation) runs on this rank's
contiguous slice of the queries; the outputs are gathered back to whole
(``sp_gather=False`` leaves a feature-propagation output sliced, for a
pointwise head). Set ``axis_name`` to include the axis for train-mode
BatchNorm.

BatchNorm has flax's semantics (:class:`BatchNorm`): momentum 0.1 and eps
1e-5, which is flax's momentum 0.9 and eps 1e-5 as the JAX package sets
them, and the running variance takes the biased batch variance. Dropout
draws from a ``torch.Generator`` that the trainer sets (:class:`Dropout`).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import (
    farthest_point_sample,
    group_points,
    index_points,
    query_ball_point,
    three_nn_interpolate,
)
from ..ops.grouping import _query_ball_radii
from ..utils.collectives import (
    all_gather,
    all_reduce_mean,
    axis_group,
    gather_columns,
    sp_shard_slice,
    sum_gradient,
)


class PointConv(nn.Module):
    """The reference's kernel-size-1 Conv1d (kdims=1) or Conv2d (kdims=2),
    stored with its shape [out, in, 1(, 1)] and applied to channel-last
    input as ``F.linear``; ``bias=False`` as the reference's bias-free
    convolutions (DGCNN). Initialised as torch initialises a convolution,
    uniform in +-1/sqrt(in), from ``generator``."""

    def __init__(self, in_ch: int, out_ch: int, kdims: int = 1,
                 generator: Optional[torch.Generator] = None, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((out_ch, in_ch) + (1,) * kdims))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None
        self.column_group = None
        bound = 1.0 / math.sqrt(in_ch)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            if bias:
                self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight.flatten(1), self.bias, self.column_group)


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
           column_group=None) -> torch.Tensor:
    """``F.linear`` over the last axis. With ``column_group`` (tensor
    parallelism, parallel/sharding.py) ``weight`` holds this rank's rows of
    the output channels: the product of its columns is gathered from the
    group's ranks in rank order, and the bias, which every rank holds
    whole, is added after, so every rank goes on with the whole output as
    the single-device layer gives it."""
    if column_group is None:
        return F.linear(x, weight, bias)
    y = gather_columns(F.linear(sum_gradient(x, column_group), weight), column_group)
    return y if bias is None else y + bias


class BatchNorm(nn.Module):
    """BatchNorm over the last axis of a channel-last tensor, with the
    semantics of flax's ``nn.BatchNorm`` as the JAX package uses it
    (models/common.py:52-57).

    Train mode normalises with the biased batch statistics over every axis
    but the channels and updates ``running_mean``/``running_var`` as
    ``(1 - momentum) * running + momentum * batch`` with the *biased* batch
    variance (torch's ``BatchNorm1d`` takes the unbiased one, n/(n-1)).
    Eval mode normalises with the running statistics. The parameter and
    buffer names are ``BatchNorm1d``'s, so state_dicts and the weight
    conversions carry over unchanged.

    ``axis_name`` (set by the model, :func:`sync_batchnorms`) makes it
    flax's ``BatchNorm(axis_name=...)``: sync-BN over the process group
    bound to that mesh axis (utils/collectives.py). The local ``mean(x)``
    and ``mean(x^2)``, stacked, take one all-reduce mean over the group,
    ``var = max(0, mean(x^2) - mean(x)^2)`` (flax's ``_compute_stats`` with
    ``use_fast_variance``), and the running statistics take that global
    biased variance. The all-reduce is inside autograd, so the gradient
    reaches every rank's rows through the shared statistics. Every rank's
    shard must hold the same number of rows, as the JAX package's pmean
    assumes.

    On a CPU tensor the single-device path hands ``F.batch_norm`` a
    channel-major copy ([1, C, rows]): over [rows, C] torch's CPU kernel
    sums the rows of each channel one after another within a thread, so
    its gradients lose accuracy as the threads get fewer; channel-major,
    they do not depend on the thread count.
    """

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        self.axis_name: Optional[str] = None
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x2 = x.reshape(-1, x.shape[-1])
        if not self.training:
            out = F.batch_norm(x2, self.running_mean, self.running_var,
                               self.weight, self.bias, False, 0.0, self.eps)
            return out.reshape(x.shape)
        if self.axis_name is not None:
            return self._synced(x2).reshape(x.shape)
        # F.batch_norm updates the running statistics from the ones it
        # computes anyway (no second pass over x), but with the unbiased
        # variance: rv = (1-m) old + m var n/(n-1). The biased update is
        # (1-m) old + m var = old (1-m)/n + rv (1 - 1/n). rv goes to a copy,
        # which autograd saves: the buffer itself is then updated in place.
        n, m = x2.shape[0], self.momentum
        rv = self.running_var.clone()
        if x2.device.type == "cpu":
            out = F.batch_norm(x2.t().contiguous()[None], self.running_mean, rv,
                               self.weight, self.bias, True, m, self.eps)[0].t()
        else:
            out = F.batch_norm(x2, self.running_mean, rv, self.weight, self.bias,
                               True, m, self.eps)
        with torch.no_grad():
            self.running_var.mul_((1.0 - m) / n).add_(rv, alpha=1.0 - 1.0 / n)
            self.num_batches_tracked.add_(1)
        return out.reshape(x.shape)

    def _synced(self, x2: torch.Tensor) -> torch.Tensor:
        xs = x2.to(torch.promote_types(x2.dtype, torch.float32))
        stats = all_reduce_mean(torch.stack([xs.mean(0), (xs * xs).mean(0)]),
                                axis_group(self.axis_name))
        mean, var = stats[0], torch.clamp(stats[1] - stats[0] * stats[0], min=0.0)
        out = (xs - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        m = self.momentum
        with torch.no_grad():
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
            self.num_batches_tracked.add_(1)
        return out.to(x2.dtype)

    def affine_from_moments(self, mu: Optional[torch.Tensor],
                            mean2: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """BatchNorm of an input it never sees, from that input's batch
        moments (the JAX package's ``_MomentBN``, models/dgcnn.py:34-70, on
        this module's parameters and buffers) -> (a, c) with BN(h) = a h + c.

        Train mode takes ``mu`` = mean(h) and ``mean2`` = mean(h^2) over
        the rows (an all-reduce mean of both over ``axis_name``'s group,
        inside autograd, where it is set), var = mean2 - mu^2 unclamped as
        ``_MomentBN`` leaves it, and updates the running statistics as
        ``forward`` does; eval mode takes the running statistics and
        ignores both."""
        if self.training:
            if self.axis_name is not None:
                stats = all_reduce_mean(torch.stack([mu, mean2]), axis_group(self.axis_name))
                mu, mean2 = stats[0], stats[1]
            var = mean2 - mu * mu
            m = self.momentum
            with torch.no_grad():
                self.running_mean.mul_(1.0 - m).add_(mu, alpha=m)
                self.running_var.mul_(1.0 - m).add_(var, alpha=m)
                self.num_batches_tracked.add_(1)
        else:
            mu, var = self.running_mean, self.running_var
        a = self.weight * torch.rsqrt(var + self.eps)
        return a, self.bias - mu * a


def sync_batchnorms(model: nn.Module, axis_name: Optional[str]) -> None:
    """Give every BatchNorm of ``model`` the mesh axis its train-mode
    statistics are taken over (None: this rank's batch alone), as the JAX
    models hand ``axis_name`` to each of theirs."""
    model.axis_name = axis_name
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.axis_name = axis_name


def rounded_to(value: float, dtype: torch.dtype) -> float:
    """A Python constant as a value of ``dtype`` takes it: what flax's
    weakly typed constants become in a half-precision operation. float32
    constants pass as they are (PyTorch takes a Python scalar at the
    tensor's precision)."""
    return value if dtype == torch.float32 else torch.tensor(value, dtype=dtype).item()


class Dropout(nn.Module):
    """Inverted dropout as flax's ``nn.Dropout``: in train mode keep each
    element with probability 1 - p and divide the kept ones by 1 - p.
    The keep mask draws from ``generator`` (a ``torch.Generator`` on the
    input's device, which the trainer seeds), or from torch's default
    generator when it is None. In a half type the divisor 1 - p is rounded
    to that type first, as flax's weakly typed constant is."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = p
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.p >= 1.0:
            return torch.zeros_like(x)
        keep = torch.empty_like(x).bernoulli_(1.0 - self.p, generator=self.generator)
        return x * keep / rounded_to(1.0 - self.p, x.dtype)


class SharedMLP(nn.Module):
    """Per-point conv + BatchNorm + ReLU stack over the last axis
    (models/common.py:30-60), parameters under ``mlp_convs.{i}`` and
    ``mlp_bns.{i}``."""

    def __init__(self, in_ch: int, widths: Sequence[int], kdims: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mlp_convs = nn.ModuleList()
        self.mlp_bns = nn.ModuleList()
        for w in widths:
            self.mlp_convs.append(PointConv(in_ch, w, kdims, generator))
            self.mlp_bns.append(BatchNorm(w))
            in_ch = w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv, bn in zip(self.mlp_convs, self.mlp_bns):
            x = F.relu(bn(conv(x)))
        return x


class SetAbstraction(SharedMLP):
    """PointNet++ single-scale set abstraction (models/common.py:81-128):
    FPS -> ball query -> centre-relative grouping -> shared MLP -> max over
    the neighbours. features [B, N, C] or None -> ([B, npoint, 3],
    [B, npoint, mlp[-1]]). ``in_ch`` counts the 3 relative coordinates.
    Its convolutions are the reference's Conv2d."""

    def __init__(self, npoint: int, radius: float, nsample: int, in_ch: int,
                 mlp: Sequence[int], generator: Optional[torch.Generator] = None,
                 sp_axis=None):
        super().__init__(in_ch, mlp, kdims=2, generator=generator)
        self.npoint = npoint
        self.radius = radius
        self.nsample = nsample
        self.sp_axis = sp_axis

    def forward(
        self, xyz: torch.Tensor, features: Optional[torch.Tensor]
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        fps_idx = farthest_point_sample(xyz, self.npoint)
        new_xyz = index_points(xyz, fps_idx)
        q_xyz = sp_shard_slice(new_xyz, self.sp_axis) if self.sp_axis else new_xyz
        idx = query_ball_point(self.radius, self.nsample, xyz, q_xyz)
        grouped = group_points(xyz, q_xyz, idx, features)  # [B,S,K,3+C]
        pooled = torch.amax(super().forward(grouped), dim=2)
        return new_xyz, all_gather(pooled, self.sp_axis) if self.sp_axis else pooled


class FeaturePropagation(SharedMLP):
    """PointNet++ decoder layer (models/common.py:209-251): 3-NN
    inverse-distance interpolation of the coarse features onto the fine
    points, concatenated after the fine skip features, then a shared MLP.
    The coarse features are cast to float32 before interpolating, as in the
    JAX layer. Its convolutions are the reference's Conv1d."""

    def __init__(self, in_ch: int, mlp: Sequence[int],
                 generator: Optional[torch.Generator] = None, sp_axis=None,
                 sp_gather: bool = True):
        super().__init__(in_ch, mlp, kdims=1, generator=generator)
        self.sp_axis, self.sp_gather = sp_axis, sp_gather

    def forward(
        self,
        xyz_fine: torch.Tensor,
        xyz_coarse: torch.Tensor,
        feats_fine: Optional[torch.Tensor],
        feats_coarse: torch.Tensor,
    ) -> torch.Tensor:
        xyz_fine, feats_fine = fine_slice(self.sp_axis, xyz_fine, feats_fine)
        interp = three_nn_interpolate(
            xyz_fine, xyz_coarse, feats_coarse.float(), k=3
        )
        if feats_fine is not None:
            interp = torch.cat([feats_fine.float(), interp], dim=-1)
        return gather_fine(super().forward(interp), self.sp_axis, self.sp_gather)


def fine_slice(sp_axis, xyz_fine: torch.Tensor, feats_fine: Optional[torch.Tensor]):
    """This rank's slice of the fine points and their skip features under
    ``sp_axis``; both whole without it."""
    if not sp_axis:
        return xyz_fine, feats_fine
    return (sp_shard_slice(xyz_fine, sp_axis),
            None if feats_fine is None else sp_shard_slice(feats_fine, sp_axis))


def gather_fine(out: torch.Tensor, sp_axis, sp_gather: bool) -> torch.Tensor:
    return all_gather(out, sp_axis) if sp_axis and sp_gather else out


class Dense(nn.Module):
    """flax's ``nn.Dense`` over the last axis, its weight stored as
    [out, in] (the flax kernel transposed). Initialised as :class:`PointConv`
    is, uniform in +-1/sqrt(in), from ``generator``. With ``dtype`` (a
    compute type, as flax's ``Dense(dtype=...)``) the input, weight and bias
    are cast to it, the product is rounded to it and the bias added in it,
    as flax computes; the parameters stay float32."""

    def __init__(self, in_ch: int, out_ch: int, bias: bool = True,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None
        self.dtype = dtype
        self.column_group = None
        bound = 1.0 / math.sqrt(in_ch)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            if bias:
                self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is None:
            return linear(x, self.weight, self.bias, self.column_group)
        dt = self.dtype
        y = linear(x.to(dt), self.weight.to(dt), None, self.column_group)
        return y if self.bias is None else y + self.bias.to(dt)


class DenseMLP(nn.Module):
    """The JAX package's ``SharedMLP`` under its flax names: Dense +
    BatchNorm + ReLU a layer, children ``dense_{i}`` and ``bn_{i}``
    (models/common.py:30-60)."""

    def __init__(self, in_ch: int, widths: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.depth = len(widths)
        for i, w in enumerate(widths):
            setattr(self, f"dense_{i}", Dense(in_ch, w, generator=generator))
            setattr(self, f"bn_{i}", BatchNorm(w))
            in_ch = w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = F.relu(getattr(self, f"bn_{i}")(getattr(self, f"dense_{i}")(x)))
        return x


def multi_scale_abstraction(xyz: torch.Tensor, features: Optional[torch.Tensor],
                            npoint: int, balls, branches,
                            sp_axis=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The loop of every MSG set abstraction: one FPS, every (radius, K) of
    ``balls`` in one ball-query launch on the card (each the same bits as
    its own query_ball_point), then for each scale a grouping, its branch
    (a shared MLP) and a max over the neighbours; the scales concatenated
    -> ([B, npoint, 3], [B, npoint, sum of the branches' widths]). With
    ``sp_axis`` the queries are this rank's slice of the centres and the
    result is gathered."""
    new_xyz = index_points(xyz, farthest_point_sample(xyz, npoint))
    q_xyz = sp_shard_slice(new_xyz, sp_axis) if sp_axis else new_xyz
    scales = [torch.amax(branch(group_points(xyz, q_xyz, idx, features)), dim=2)
              for branch, idx in zip(branches, _query_ball_radii(balls, xyz, q_xyz))]
    out = torch.cat(scales, dim=-1)
    return new_xyz, all_gather(out, sp_axis) if sp_axis else out


class MultiScaleSetAbstraction(nn.Module):
    """PointNet++ MSG set abstraction (models/common.py:131-169): one FPS,
    then for each radius a ball query (all radii in one launch on the card),
    grouping, a shared MLP ``mlp_{i}`` and a max over the neighbours; the
    scales are concatenated. Every scale takes the SAME width list, so the
    output is len(radius_list) * mlp[-1] wide. ``in_ch`` counts the 3
    relative coordinates."""

    def __init__(self, npoint: int, radius_list: Sequence[float],
                 nsample_list: Sequence[int], in_ch: int, mlp: Sequence[int],
                 generator: Optional[torch.Generator] = None, sp_axis=None):
        super().__init__()
        self.npoint = npoint
        self.sp_axis = sp_axis
        self.radius_list = tuple(radius_list)
        self.nsample_list = tuple(nsample_list)
        for i in range(len(self.radius_list)):
            setattr(self, f"mlp_{i}", DenseMLP(in_ch, mlp, generator))

    def forward(
        self, xyz: torch.Tensor, features: Optional[torch.Tensor]
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        balls = tuple(zip(self.radius_list, self.nsample_list))
        branches = [getattr(self, f"mlp_{i}") for i in range(len(balls))]
        return multi_scale_abstraction(xyz, features, self.npoint, balls, branches,
                                       self.sp_axis)


class FeatFirstConv(PointConv):
    """The first Conv2d of a reference MSG branch: its weight [O, C + 3, 1,
    1] is stored over the reference's input order [features, rel-xyz]
    (pointnet_util.py:265-267) and applied to grouped input in the order
    group_points gives, [rel-xyz, features]: the last 3 columns move to the
    front, one small copy a forward. With no features (C = 0) the order is
    the same."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.flatten(1)
        return linear(x, torch.cat([w[:, -3:], w[:, :-3]], dim=1), self.bias,
                      self.column_group)


class MultiScaleSetAbstractionMsg(nn.Module):
    """The Partsize MSG set abstraction with a DIFFERENT width list a scale
    (models/common.py:172-206; the reference's PointNetSetAbstractionMsg,
    pointnet_util.py:222-284): the loop of :func:`multi_scale_abstraction`,
    branch ``b`` a stack of Conv2d ``conv_blocks.{b}.{j}`` + BatchNorm
    ``bn_blocks.{b}.{j}`` + ReLU. The output is the sum of the branches'
    last widths. ``in_ch`` counts the 3 relative coordinates. The first
    conv of a branch (:class:`FeatFirstConv`) is stored in the reference's
    [features, rel-xyz] order, so a reference checkpoint's weights load
    unchanged."""

    def __init__(self, npoint: int, radius_list: Sequence[float],
                 nsample_list: Sequence[int], in_ch: int, mlp_list: Sequence[Sequence[int]],
                 generator: Optional[torch.Generator] = None, sp_axis=None):
        super().__init__()
        self.npoint = npoint
        self.sp_axis = sp_axis
        self.balls = tuple(zip(radius_list, nsample_list))
        self.conv_blocks = nn.ModuleList()
        self.bn_blocks = nn.ModuleList()
        for mlp in mlp_list:
            convs, bns, c = nn.ModuleList(), nn.ModuleList(), in_ch
            for w in mlp:
                convs.append((PointConv if len(convs) else FeatFirstConv)(c, w, 2, generator))
                bns.append(BatchNorm(w))
                c = w
            self.conv_blocks.append(convs)
            self.bn_blocks.append(bns)

    def branch(self, b: int, x: torch.Tensor) -> torch.Tensor:
        """Branch ``b``'s shared MLP over grouped [B, S, K, 3 + C]."""
        for conv, bn in zip(self.conv_blocks[b], self.bn_blocks[b]):
            x = F.relu(bn(conv(x)))
        return x

    def forward(
        self, xyz: torch.Tensor, features: Optional[torch.Tensor]
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        branches = [functools.partial(self.branch, b) for b in range(len(self.balls))]
        return multi_scale_abstraction(xyz, features, self.npoint, self.balls, branches,
                                       self.sp_axis)


class GroupAllAbstraction(SharedMLP):
    """The ``group_all`` set abstraction of the classifiers
    (cls_models.py:27-43): every point in one group, [xyz, features]
    concatenated, a shared MLP of the reference's Conv2d over
    [B, 1, N, 3 + C] and a max over the points -> [B, mlp[-1]]. No kernel
    runs here. ``in_ch`` counts the 3 coordinates."""

    def __init__(self, in_ch: int, mlp: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_ch, mlp, kdims=2, generator=generator)

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor]) -> torch.Tensor:
        grouped = xyz if features is None else torch.cat([xyz, features], dim=-1)
        return torch.amax(super().forward(grouped[:, None]), dim=2)[:, 0]


class EnhancedFeaturePropagation(nn.Module):
    """Attention- and boundary-augmented decoder layer
    (models/common.py:254-315): 4-NN interpolation of the coarse features,
    concatenated after the fine skip features; a channel-attention gate on
    the result; a shared MLP, with a residual when the widths line up; and
    an MLP of the fine coordinates added on top. ``in_ch`` is the width
    after the concatenation."""

    def __init__(self, in_ch: int, mlp: Sequence[int],
                 generator: Optional[torch.Generator] = None, sp_axis=None,
                 sp_gather: bool = True):
        super().__init__()
        g = generator
        self.sp_axis, self.sp_gather = sp_axis, sp_gather
        self.residual = in_ch == mlp[-1]
        self.attn_dense0 = Dense(in_ch, in_ch // 4, generator=g)
        self.attn_bn = BatchNorm(in_ch // 4)
        self.attn_dense1 = Dense(in_ch // 4, in_ch, generator=g)
        self.mlp = DenseMLP(in_ch, mlp, g)
        self.boundary_mlp0 = DenseMLP(3, (16,), g)
        self.boundary_dense1 = Dense(16, mlp[-1], generator=g)

    def forward(
        self,
        xyz_fine: torch.Tensor,
        xyz_coarse: torch.Tensor,
        feats_fine: Optional[torch.Tensor],
        feats_coarse: torch.Tensor,
    ) -> torch.Tensor:
        xyz_fine, feats_fine = fine_slice(self.sp_axis, xyz_fine, feats_fine)
        fused = three_nn_interpolate(xyz_fine, xyz_coarse, feats_coarse, k=4)
        if feats_fine is not None:
            fused = torch.cat([feats_fine, fused], dim=-1)
        attn = F.relu(self.attn_bn(self.attn_dense0(fused)))
        fused = fused * torch.sigmoid(self.attn_dense1(attn))
        out = self.mlp(fused)
        if self.residual:
            out = out + fused
        out = out + self.boundary_dense1(self.boundary_mlp0(xyz_fine))
        return gather_fine(out, self.sp_axis, self.sp_gather)


class SegHead(nn.Module):
    """Per-point classification head (models/common.py:318-342):
    conv1 + bn1 + ReLU + dropout + conv2. Dropout acts only in train mode."""

    def __init__(self, in_ch: int, num_classes: int, hidden: int = 128,
                 dropout: float = 0.5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = PointConv(in_ch, hidden, 1, generator)
        self.bn1 = BatchNorm(hidden)
        self.drop1 = Dropout(dropout)
        self.conv2 = PointConv(hidden, num_classes, 1, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        return self.conv2(self.drop1(x))
