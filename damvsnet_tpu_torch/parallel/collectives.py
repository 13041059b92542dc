"""Collectives under autograd, over the public ``torch.distributed`` calls.

``all_reduce_sum``: every rank gets the sum of the ranks' tensors; its
backward sums the ranks' gradients, since each rank's loss reads the sum.

``slice_tokens`` / ``gather_tokens``: a tensor replicated on every rank of a
group, cut into one contiguous part per rank along a dimension, and put
back together. Every rank computes the same loss from replicated values,
so the gradient of a replicated tensor is the whole gradient on every
rank: the backward of a slice gathers the parts' gradients, and that of a
gather keeps this rank's part.

``sum_backward``: the identity on a replicated tensor that every rank's
slab computation reads whole (the views' features, the depth-slab axis's
``parallel/slab.py``); each rank's backward holds only its slab's share,
and the op sums the shares over the group.

``exchange_halo``: a slab with its neighbours' boundary planes along one
dimension, zeros at the two ends of the global axis; its backward returns
each halo plane's gradient to the rank that owns the plane. Both ways the
planes travel in one all-gather of every rank's boundary planes, which
runs on NCCL and on gloo alike (gloo's point-to-point calls take no CUDA
tensors).
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


class _SumBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def sum_backward(x: torch.Tensor, group) -> torch.Tensor:
    """x itself; its gradient is summed over the group's ranks."""
    return _SumBackward.apply(x, group)


def _swap(to_prev, to_next, n_from_prev, n_from_next, dim, group):
    """Send ``to_prev`` (planes for the previous rank) and ``to_next``
    (for the next one); receive ``n_from_prev`` planes from the previous
    rank and ``n_from_next`` from the next, zeros where there is no rank.
    Every rank of the group calls it with the same plane counts: one
    all-gather of every rank's [to_prev | to_next] planes."""
    r, n = dist.get_rank(group), dist.get_world_size(group)

    def zeros(like, k):
        shape = list(like.shape)
        shape[dim] = k
        return like.new_zeros(shape)

    from_prev, from_next = zeros(to_prev, n_from_prev), zeros(to_next, n_from_next)
    mine = torch.cat([to_prev, to_next], dim).contiguous()
    parts = [torch.empty_like(mine) for _ in range(n)]
    dist.all_gather(parts, mine, group=group)
    if r > 0 and n_from_prev:
        from_prev = parts[r - 1].narrow(dim, to_prev.shape[dim], n_from_prev)
    if r < n - 1 and n_from_next:
        from_next = parts[r + 1].narrow(dim, 0, n_from_next)
    return from_prev, from_next


class _ExchangeHalo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, before, after, group):
        ctx.dim, ctx.before, ctx.after, ctx.group = dim, before, after, group
        size = x.shape[dim]
        # the previous rank needs my first `after` planes, the next my last `before`
        from_prev, from_next = _swap(x.narrow(dim, 0, after), x.narrow(dim, size - before, before),
                                     before, after, dim, group)
        # in x's memory format: cat of mixed formats falls back to the
        # contiguous one, and a channels_last_3d volume must stay so for
        # its convolutions to run as the whole volume's do
        shape = list(x.shape)
        shape[dim] += before + after
        fmt = (torch.channels_last_3d if x.dim() == 5 and not x.is_contiguous()
               and x.is_contiguous(memory_format=torch.channels_last_3d)
               else torch.contiguous_format)
        out = torch.empty(shape, dtype=x.dtype, device=x.device, memory_format=fmt)
        return torch.cat([from_prev, x, from_next], dim, out=out)

    @staticmethod
    def backward(ctx, grad):
        dim, before, after = ctx.dim, ctx.before, ctx.after
        size = grad.shape[dim] - before - after
        # the halo planes' gradients go back to their owners: the first
        # `before` to the previous rank (its last planes), the last `after`
        # to the next (its first planes)
        from_prev, from_next = _swap(grad.narrow(dim, 0, before),
                                     grad.narrow(dim, before + size, after),
                                     after, before, dim, ctx.group)
        own = grad.narrow(dim, before, size).clone()
        own.narrow(dim, 0, after).add_(from_prev)
        own.narrow(dim, size - before, before).add_(from_next)
        return own, None, None, None, None


def exchange_halo(x: torch.Tensor, dim: int, before: int, after: int, group) -> torch.Tensor:
    """x, this rank's slab of a tensor cut into contiguous slabs along
    ``dim`` over the group's ranks in order, with ``before`` planes of the
    previous rank's slab in front and ``after`` planes of the next rank's
    behind (zeros past the ends of the global axis). Every slab holds at
    least ``max(before, after)`` planes."""
    if x.shape[dim] < max(before, after):
        raise ValueError(f"a slab of {x.shape[dim]} planes along dim {dim} cannot "
                         f"give a halo of {max(before, after)}")
    return _ExchangeHalo.apply(x, dim, before, after, group)
