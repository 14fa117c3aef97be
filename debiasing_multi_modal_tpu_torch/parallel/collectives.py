"""Differentiable collectives (the port's counterparts of the collectives
XLA inserts from sharding annotations and of ``jax.lax.all_to_all``).

Conventions (Megatron's): a tensor outside a sharded region is replicated,
and every rank computes the same objective from it.

- :func:`copy_to_group` ("f"): identity forward, all-reduce backward; at the
  input of a column-parallel layer.
- :func:`reduce_from_group` ("g"): all-reduce forward, identity backward;
  the sum of a row-parallel layer's partial products.
- :func:`all_reduce_sum`: all-reduce forward and backward; a sum over ranks
  whose result feeds each rank's own share of the objective (the masked
  BatchNorm's statistics under data parallelism).
- :func:`all_to_all`: ``all_to_all_single`` over the leading axis, its
  backward the same exchange of the gradients.
- :func:`split_to_group` / :func:`gather_from_group`: a rank's chunk of a
  replicated tensor along one axis (backward: all-gather), and the chunks
  of every rank concatenated in rank order (backward: the local chunk).

The JAX package's ``jax.lax`` collectives take an axis name; these take the
process group of a mesh axis.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=group)
    return out


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _chunk(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    return x.chunk(n, dim=dim)[dist.get_rank(group)].contiguous()


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = torch.empty_like(grad, memory_format=torch.contiguous_format)
        dist.all_to_all_single(out, grad.contiguous(), group=ctx.group)
        return out, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _chunk(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad, ctx.group, ctx.dim), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return _chunk(grad, ctx.group, ctx.dim), None, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return _Copy.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return _Reduce.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduceSum.apply(x, group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """Element-wise maximum over the group (no gradient)."""
    return _all_reduce(x.detach(), group, dist.ReduceOp.MAX)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Block ``j`` of ``x``'s leading axis goes to rank ``j``; block ``j``
    of the result came from rank ``j``."""
    return _AllToAll.apply(x, group)


def split_to_group(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return _Split.apply(x, group, dim)


def gather_from_group(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return _Gather.apply(x, group, dim)
