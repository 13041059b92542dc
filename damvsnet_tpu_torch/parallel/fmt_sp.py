"""Sequence-parallel linear attention for FMT; counterpart of
damvsnet_tpu/parallel/fmt_sp.py.

FMT's kernelized attention keeps one d x d summary per head,
KV = sum_s K_s V_s^T, and the normalizer's sum_s K_s. Both are sums over
the tokens, so each rank of a group takes a contiguous part of the tokens,
sums its part, and one all-reduce gives every rank the whole; each rank
then finishes its own queries and an all-gather returns the whole output.
Exact, up to the order of the sums. The operands and the result are
replicated on every rank, as in the JAX package's ``shard_map``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .collectives import all_reduce_sum, gather_tokens, slice_tokens


def sequence_parallel_linear_attention(q, k, v, group, eps: float = 1e-6):
    """q [Bq, L, H, D], k and v [Bk, L, H, D] on every rank of ``group``,
    whose size divides L; Bk divides Bq, query batch entry i attending to
    key batch entry i // (Bq / Bk) (``nn/fmt.py::linear_attention``).
    Returns [Bq, L, H, D] in q's dtype, computed in fp32 as
    ``linear_attention``; differentiable."""
    dtype = q.dtype
    qf = F.elu(slice_tokens(q.float(), 1, group)) + 1.0
    kf = F.elu(slice_tokens(k.float(), 1, group)) + 1.0
    vf = slice_tokens(v.float(), 1, group)
    bk, _, h, d = kf.shape
    m = vf.shape[-1]
    partial = torch.cat([torch.einsum("nshd,nshm->nhmd", kf, vf).reshape(bk, -1),
                         kf.sum(dim=1).reshape(bk, -1)], dim=1)
    kv, ksum = all_reduce_sum(partial, group).split([h * m * d, h * d], dim=1)
    kv, ksum = kv.reshape(bk, h, m, d), ksum.reshape(bk, h, d)
    rep = qf.shape[0] // bk
    if rep > 1:
        kv, ksum = kv.repeat_interleave(rep, dim=0), ksum.repeat_interleave(rep, dim=0)
    z = 1.0 / (torch.einsum("nlhd,nhd->nlh", qf, ksum) + eps)
    out = torch.einsum("nlhd,nhmd->nlhm", qf, kv) * z[..., None]
    return gather_tokens(out, 1, group).to(dtype)


def sequence_parallel_applies(group, q_len: int, k_len: int) -> bool:
    """JAX's condition (damvsnet_tpu/nn/fmt.py:43-52,68): a group of more
    than one rank whose size divides the tokens, and as many keys as
    queries."""
    if group is None or q_len != k_len:
        return False
    size = dist.get_world_size(group)
    return size > 1 and q_len % size == 0
