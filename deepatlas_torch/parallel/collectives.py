"""Bucketed and differentiable collectives over a mesh axis.

Counterpart of ``deepatlas_tpu/parallel/collectives.py``.  ``pmean_tree``
and ``psum_tree`` reduce a whole tree of tensors with one flattened
all-reduce per dtype (a train step's ~50 gradient tensors, its BatchNorm
statistics and its metric scalars ride one collective), in place, and are
the identity at axis size 1: no collective runs.  ``axes`` may be one axis
or several (a DP x SP step reduces over both); the reduction then runs once
per axis of size > 1.

``psum`` is differentiable as ``lax.psum`` is under ``shard_map`` without
replication tracking: its backward is another sum over the axis.  A loss
built from ``psum``-reduced terms is the same value on every rank, and
seeding each rank's backward with 1 then hands each rank ``n`` times its
share of the gradient; the steps of ``spatial.py`` divide the summed
per-rank gradients by ``n`` (``pmean_tree``), which recovers the
single-process gradient exactly, as the JAX steps do (their note at
``parallel/spatial.py``).  ``pmax`` is not differentiated (the dice loss
takes it of class weights, which depend on labels only).
"""
from __future__ import annotations

from typing import Iterable, Optional, Sequence, Union

import torch
import torch.distributed as dist

from .mesh import Axis

Axes = Union[None, Axis, Sequence[Optional[Axis]]]


def _axes(axes: Axes) -> list:
    if axes is None:
        return []
    if isinstance(axes, Axis):
        axes = [axes]
    return [a for a in axes if a is not None and a.size > 1]


def axis_size(axes: Axes) -> int:
    n = 1
    for a in _axes(axes):
        n *= a.size
    return n


def _leaves(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def _reduce_(tensors: Iterable[torch.Tensor], axes: Axes, mean: bool):
    axes = _axes(axes)
    tensors = list(tensors)
    if not axes or not tensors:
        return
    groups: dict = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    n = axis_size(axes)
    for ts in groups.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        for ax in axes:
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=ax.group)
        if mean:
            flat /= n
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def pmean_tree(tree, axes: Axes):
    """Replace every tensor of ``tree`` (tensors, or dicts / lists / tuples
    of them) by its mean over ``axes``, in place, with one all-reduce per
    dtype and axis; the identity at total size 1.  Returns ``tree``."""
    with torch.no_grad():
        _reduce_(_leaves(tree), axes, mean=True)
    return tree


def psum_tree(tree, axes: Axes):
    """``pmean_tree``'s sum."""
    with torch.no_grad():
        _reduce_(_leaves(tree), axes, mean=False)
    return tree


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes = axes
        y = x.clone()
        for ax in axes:
            dist.all_reduce(y, op=dist.ReduceOp.SUM, group=ax.group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        for ax in ctx.axes:
            dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ax.group)
        return g, None


def psum(x: torch.Tensor, axes: Axes) -> torch.Tensor:
    """Differentiable sum of ``x`` over ``axes`` (backward: the sum of the
    cotangents, see the module's note); ``x`` itself at size 1."""
    axes = _axes(axes)
    return _PSum.apply(x, axes) if axes else x


def psum_many(tensors: Sequence[torch.Tensor], axes: Axes) -> list:
    """``psum`` of several tensors of one dtype in one all-reduce."""
    axes = _axes(axes)
    if not axes:
        return list(tensors)
    shapes = [t.shape for t in tensors]
    flat = psum(torch.cat([t.reshape(-1) for t in tensors]), axes)
    out, off = [], 0
    for s in shapes:
        n = int(torch.Size(s).numel())
        out.append(flat[off:off + n].view(s))
        off += n
    return out


def pmax(x: torch.Tensor, axes: Axes) -> torch.Tensor:
    """Max of ``x`` over ``axes``, not differentiated."""
    axes = _axes(axes)
    if not axes:
        return x
    y = x.detach().clone()
    for ax in axes:
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=ax.group)
    return y


def all_gather(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """The ranks' ``x`` concatenated along dim 0 in axis order (``tiled``
    ``lax.all_gather``); ``x`` at size 1.  Under gloo a CUDA tensor is
    gathered through the host (gloo gathers CPU tensors only)."""
    if axis is None or axis.size == 1:
        return x
    src = x.detach().contiguous()
    host = axis.backend == "gloo" and src.is_cuda
    if host:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(axis.size)]
    dist.all_gather(parts, src, group=axis.group)
    return torch.cat(parts, dim=0).to(x.device)


def param_grads(model: torch.nn.Module) -> list:
    """Every parameter's gradient, zeros where the backward left none, so
    that every rank reduces the same list."""
    out = []
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        out.append(p.grad)
    return out


def batchnorm_stats(model: torch.nn.Module) -> list:
    """The running means and variances of ``model``'s BatchNorms."""
    from ..models.layers import BatchNorm
    return [t for m in model.modules() if isinstance(m, BatchNorm)
            for t in (m.running_mean, m.running_var)]


def broadcast_(tensors: Iterable[torch.Tensor], axes: Axes,
               src_index: int = 0) -> None:
    """Overwrite ``tensors`` on every rank of ``axes`` with the values of
    the rank at ``src_index`` along each axis (in place)."""
    for ax in _axes(axes):
        for t in tensors:
            with torch.no_grad():
                dist.broadcast(t.data, src=ax.ranks[src_index],
                               group=ax.group)
