"""Named mesh axes and the collectives that carry a gradient.

The JAX package names a mesh axis ("data", "model") and its modules reduce
over it by name (``lax.pmean(x, axis_name)``). Here a name is bound to the
``torch.distributed`` process group of this rank along that axis
(:func:`bind_axis`, which ``parallel/mesh.py`` calls when it builds a mesh),
and the modules look it up by the same name (:func:`axis_group`).

Each collective that sits inside a forward is a ``torch.autograd.Function``
whose backward is the collective the chain rule asks for:

- :func:`all_reduce_mean`: the mean over the group; its backward is the
  mean of the cotangents, so that the gradients each rank computes, summed
  over the ranks, are those of the sum of the ranks' objectives (sync-BN's
  statistics);
- :func:`gather_rows` and :func:`gather_columns`: every rank's tensor
  concatenated along dim 0 or the last dim; each rank holds the same
  cotangent of the result, so the backward keeps this rank's slice of it;
- :func:`sum_gradient`: the identity, whose backward sums the cotangents
  over the group (the input of a column-parallel product, whose ranks each
  compute a part of its gradient).

The collectives of the JAX package's ``shard_map`` bodies (sequence,
pipeline and expert parallelism) are the exact transposes JAX gives them:

- :func:`psum`: the sum over the group; its backward sums the cotangents;
- :func:`all_gather`: ``jax.lax.all_gather(x, axis, axis=dim, tiled=True)``;
  its backward sums the cotangents over the group and keeps this rank's
  slice (a reduce-scatter);
- :func:`ppermute`: a rotation by ``shift`` ranks over the axis (rank i's
  tensor goes to rank i + shift); its backward is the reverse rotation.

With these, autograd on each rank computes its share of the gradient of the
sum of the ranks' objectives. Where every rank computes the same global
loss L, that sum is R L over R ranks: the gradient of a parameter is the
sum of its holders' gradients over R (parallel/sp.py, pp.py, ep.py).
:func:`axis_index`, :func:`axis_size` and :func:`sp_shard_slice` complete
the JAX vocabulary. A tuple of names, such as ``("data", "sp")``, is the
group over those axes together, bound when the mesh is built.

Transport: gloo moves CUDA tensors in ``all_reduce`` and ``broadcast``
alone (torch's table of backends), so under gloo a CUDA tensor's
``all_gather``, send and receive go through host memory, chosen by the
backend (:func:`wire_device`), never by a failed call. The kernels stay on
the card either way. NCCL moves them directly.

A plain in-place ``dist.all_reduce`` inside a forward would cut the graph:
the gradient through the other ranks' statistics would be lost.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Union

import torch
import torch.distributed as dist

_AXES: Dict[Any, Any] = {}

Axis = Union[str, Sequence[str]]


def _key(name: Axis):
    if isinstance(name, str):
        return name
    names = frozenset(name)
    return next(iter(names)) if len(names) == 1 else names


def bind_axis(name: Axis, group: Any) -> None:
    """Bind the mesh axis ``name`` (or a tuple of axes, in any order) to
    this rank's process group along it."""
    _AXES[_key(name)] = group


def axis_group(name: Axis) -> Any:
    """The process group bound to ``name`` (a tuple: the group over those
    axes together); a name that no mesh bound is an error, as an unbound
    axis name is in JAX."""
    try:
        return _AXES[_key(name)]
    except KeyError:
        raise RuntimeError(
            f"axis {name!r} is bound to no process group: build a mesh first "
            "(parallel.make_mesh, make_named_mesh, make_2d_mesh or make_fsdp_mesh)") from None


def bind_mesh_axes(axes: Sequence[str], groups: Dict[str, Any], world: Any) -> None:
    """Bind each axis of a mesh over the whole world to its group, and the
    tuple of all its axes to the world (the group over both axes of a 2-D
    mesh)."""
    for axis in axes:
        bind_axis(axis, groups[axis])
    if len(axes) > 1:
        bind_axis(tuple(axes), world)


def axis_size(name: Axis) -> int:
    """The number of ranks along ``name`` (``jax.lax.axis_size``)."""
    return dist.get_world_size(axis_group(name))


def axis_index(name: Axis) -> int:
    """This rank's index along ``name`` (``jax.lax.axis_index``): its rank
    in the axis's group, which runs in the mesh's row-major order."""
    return dist.get_rank(axis_group(name))


def wire_device(t: torch.Tensor, group: Any) -> torch.device:
    """Where a collective other than all_reduce and broadcast moves ``t``:
    host memory under gloo (its all_gather, send and receive take CPU
    tensors), the card under NCCL (which takes CUDA tensors alone)."""
    if dist.get_backend(group) == "gloo":
        return torch.device("cpu")
    return t.device if t.is_cuda else torch.device("cuda", torch.cuda.current_device())


def gather_list(t: torch.Tensor, group: Any) -> list:
    """Every rank's ``t`` (of one shape), in group rank order, outside
    autograd; on t's device."""
    src = t.detach().to(wire_device(t, group)).contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return [p.to(t.device) for p in parts]


def rotate(t: torch.Tensor, group: Any, shift: int = 1) -> torch.Tensor:
    """Rank i's ``t`` handed to rank i + shift (mod the group's size), one
    send and one receive a rank, outside autograd."""
    size = dist.get_world_size(group)
    if size == 1 or shift % size == 0:
        return t.clone()
    me = dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + shift) % size)
    src = dist.get_global_rank(group, (me - shift) % size)
    send = t.detach().to(wire_device(t, group)).contiguous()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, dst, group), dist.P2POp(dist.irecv, recv, src, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(t.device)


def sum_plain(t: torch.Tensor, group: Any) -> torch.Tensor:
    """The sum of every rank's ``t`` over the group, outside autograd."""
    out = t.detach().clone()
    dist.all_reduce(out, group=group)
    return out


class _AllReduceMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out.div_(dist.get_world_size(group))

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g.div_(dist.get_world_size(ctx.group)), None


class _Gather(torch.autograd.Function):
    """Every rank's x concatenated along ``dim``. The backward keeps this
    rank's slice of the cotangent, summed over the group first where
    ``summed`` (the reduce-scatter: the ranks' cotangents differ)."""

    @staticmethod
    def forward(ctx, x, group, dim, summed):
        ctx.group, ctx.dim, ctx.summed = group, dim, summed
        ctx.rank, ctx.size = dist.get_rank(group), x.shape[dim]
        return torch.cat(gather_list(x, group), dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            g = sum_plain(g, ctx.group)
        return g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size).contiguous(), None, None, None


class _SumGradient(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return sum_plain(x, group)

    @staticmethod
    def backward(ctx, g):
        return sum_plain(g, ctx.group), None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return rotate(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return rotate(g, ctx.group, -ctx.shift), None, None


def psum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``jax.lax.psum(x, axis)`` with its transpose as the backward."""
    return _PSum.apply(x, axis_group(axis))


def all_gather(x: torch.Tensor, axis: Axis, dim: int = 1) -> torch.Tensor:
    """``jax.lax.all_gather(x, axis, axis=dim, tiled=True)``: the ranks'
    tensors concatenated along ``dim`` in axis-index order; the backward
    is the reduce-scatter of the cotangents."""
    return _Gather.apply(x, axis_group(axis), dim, True)


def ppermute(x: torch.Tensor, axis: Axis, shift: int = 1) -> torch.Tensor:
    """``jax.lax.ppermute`` by a rotation: axis index i's ``x`` goes to
    index i + shift (mod the axis size); the backward rotates the
    cotangents back. Every rank of the axis must call it in the same order,
    in the forward and in the backward."""
    return _PPermute.apply(x, axis_group(axis), shift)


def sp_shard_slice(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """This rank's contiguous block of t's axis 1 (models/common.py:63 of
    the JAX package): the axis split into P equal slices in axis-index
    order, so :func:`all_gather` along dim 1 restores it."""
    p = axis_size(axis)
    n = t.shape[1]
    if n % p:
        raise ValueError(
            f"sequence-parallel axis of length {n} must divide the mesh axis size {p}")
    s = n // p
    return t.narrow(1, axis_index(axis) * s, s)


def all_reduce_mean(x: torch.Tensor, group: Any) -> torch.Tensor:
    return _AllReduceMean.apply(x, group)


def gather_rows(x: torch.Tensor, group: Any) -> torch.Tensor:
    return _Gather.apply(x, group, 0, False)


def gather_columns(x: torch.Tensor, group: Any) -> torch.Tensor:
    return _Gather.apply(x, group, x.dim() - 1, False)


def sum_gradient(x: torch.Tensor, group: Any) -> torch.Tensor:
    return _SumGradient.apply(x, group)
