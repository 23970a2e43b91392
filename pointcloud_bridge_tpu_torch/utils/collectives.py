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

A plain in-place ``dist.all_reduce`` inside a forward would cut the graph:
the gradient through the other ranks' statistics would be lost.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.distributed as dist

_AXES: Dict[str, Any] = {}


def bind_axis(name: str, group: Any) -> None:
    """Bind the mesh axis ``name`` to this rank's process group along it."""
    _AXES[name] = group


def axis_group(name: str) -> Any:
    """The process group bound to ``name``; a name that no mesh bound is an
    error, as an unbound axis name is in JAX."""
    try:
        return _AXES[name]
    except KeyError:
        raise RuntimeError(
            f"axis '{name}' is bound to no process group: build a mesh first "
            "(parallel.make_mesh, make_2d_mesh or make_fsdp_mesh)") from None


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
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        ctx.rank, ctx.size = dist.get_rank(group), x.shape[dim]
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None, None


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


def all_reduce_mean(x: torch.Tensor, group: Any) -> torch.Tensor:
    return _AllReduceMean.apply(x, group)


def gather_rows(x: torch.Tensor, group: Any) -> torch.Tensor:
    return _Gather.apply(x, group, 0)


def gather_columns(x: torch.Tensor, group: Any) -> torch.Tensor:
    return _Gather.apply(x, group, x.dim() - 1)


def sum_gradient(x: torch.Tensor, group: Any) -> torch.Tensor:
    return _SumGradient.apply(x, group)
