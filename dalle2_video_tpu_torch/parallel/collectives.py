"""Differentiable collectives over one mesh axis, built from the three
every backend has (all-reduce, all-gather, broadcast): gloo has no
reduce-scatter, so a reduce-scatter is an all-reduce and a slice.

Each function says what a value is on the axis -- replicated (every rank
holds the same) or sharded (each rank its block) -- because that decides
the backward. ``torch.distributed.nn.functional.all_gather`` sums the
cotangents of every rank; where the gathered value feeds a replicated
computation, every rank holds the same cotangent and that sum would
inflate the gradient by the axis size. So:

  ``gather_sharded``    block -> whole; backward: the sum over the ranks'
                        partial cotangents, this rank's block of it;
  ``gather_replicated`` block -> whole, consumed identically on every rank;
                        backward: this rank's block of the (same) cotangent;
  ``shard_replicated``  whole (replicated) -> this rank's block; backward:
                        the blocks' cotangents gathered;
  ``sum_cotangent``     identity; backward: the cotangent summed over the
                        axis (a replicated input used by a sharded part);
  ``psum``              the sum over the axis; backward: identity (each
                        rank's part of a sum every rank then holds).

A ``group`` of None is a one-rank axis: every function is the identity.
The raw collectives (``all_reduce_``, ``all_gather_list``, ``broadcast_``)
run a gloo group's CUDA tensors on host copies (gloo stages CUDA through
the host; this keeps to the collectives every gloo build carries for CPU
tensors), NCCL's on the device.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _on_host(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over ``group`` in place (a contiguous tensor); returns x."""
    if _on_host(x, group):
        host = x.cpu()
        dist.all_reduce(host, op=dist.ReduceOp.SUM, group=group)
        x.copy_(host)
    else:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def all_gather_list(x: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's x (equal shapes), in rank order, on x's device."""
    src = x.contiguous().cpu() if _on_host(x, group) else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return [p.to(x.device) for p in parts]


def broadcast_(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """Global rank ``src``'s x into x on every rank of ``group``; returns x."""
    if _on_host(x, group):
        host = x.cpu()
        dist.broadcast(host, src=src, group=group)
        x.copy_(host)
    else:
        dist.broadcast(x, src=src, group=group)
    return x


def all_gather_cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' blocks concatenated along ``dim`` (no gradient)."""
    if _size(group) == 1:
        return x
    return torch.cat(all_gather_list(x, group), dim=dim)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the axis, out of place (no gradient)."""
    out = x.detach().clone().contiguous()
    return out if group is None else all_reduce_(out, group)


def block(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (a view)."""
    n = _size(group)
    if x.shape[dim] % n:
        raise ValueError(f"axis of {x.shape[dim]} does not divide over {n} ranks")
    per = x.shape[dim] // n
    return x.narrow(dim, _rank(group) * per, per)


class _GatherSharded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return block(all_reduce_sum(g, ctx.group), ctx.group, ctx.dim).contiguous(), None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return block(g, ctx.group, ctx.dim).contiguous(), None, None


class _ShardReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return block(x, group, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, ctx.group, ctx.dim), None, None


class _SumCotangent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def gather_sharded(x, group, dim: int = 0):
    return x if group is None else _GatherSharded.apply(x, group, dim)


def gather_replicated(x, group, dim: int = 0):
    return x if group is None else _GatherReplicated.apply(x, group, dim)


def shard_replicated(x, group, dim: int = 0):
    return x if group is None else _ShardReplicated.apply(x, group, dim)


def sum_cotangent(x, group):
    return x if group is None else _SumCotangent.apply(x, group)


def psum(x, group):
    return x if group is None else _Psum.apply(x, group)
