"""Collectives under autograd, over the public ``torch.distributed`` calls.

``all_reduce_sum``: every rank gets the sum of the ranks' tensors; its
backward sums the ranks' gradients, since each rank's loss reads the sum.

``slice_tokens`` / ``gather_tokens``: a tensor replicated on every rank of a
group, cut into one contiguous part per rank along a dimension, and put
back together. Every rank computes the same loss from replicated values,
so the gradient of a replicated tensor is the whole gradient on every
rank: the backward of a slice gathers the parts' gradients, and that of a
gather keeps this rank's part.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduceSum.apply(x, group)


def _gather(part: torch.Tensor, dim: int, group) -> torch.Tensor:
    parts = [torch.empty_like(part) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, part.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _part(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x.chunk(dist.get_world_size(group), dim=dim)[dist.get_rank(group)]


class _SliceTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _part(x, dim, group).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad, ctx.dim, ctx.group), None, None


class _GatherTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, part, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(part, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _part(grad, ctx.dim, ctx.group).contiguous(), None, None


def slice_tokens(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's contiguous part of a replicated ``x`` along ``dim``
    (which the group's size divides)."""
    return _SliceTokens.apply(x, dim, group)


def gather_tokens(part: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's part along ``dim``, in rank order: the replicated whole."""
    return _GatherTokens.apply(part, dim, group)
