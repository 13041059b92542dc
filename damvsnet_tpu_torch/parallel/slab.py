"""The depth-slab axis: CostRegNet's blocks with each rank of a space group
holding one slab of the depth hypotheses; counterpart of
damvsnet_tpu/parallel/mesh.py::slab_constraint. CostRegNet's forward
runs each block through ``run_block`` when it has a slab group.

JAX places the data and lets GSPMD insert the halos; here the placement
is explicit, level by level, by JAX's rule (``slabbed``): a volume or
U-Net level whose D the group's size S divides (and D >= S) is cut into S
contiguous slabs of D/S planes, rank i holding planes [i D/S, (i+1) D/S).
At a level that does not divide (stage 3's D=1 bottleneck at S=2; also
its D=2 level at S=4), JAX shards the channels; the port runs that level
whole on every rank after an all-gather of its small input (at most
1 x 64 x 1 x (H/8) x (W/8) at serving), the same function.

Each block of a level runs with the block's own weights:

  * 3x3x3, stride 1, pad 1: one halo plane from each neighbour
    (``exchange_halo``), then the convolution with D padding 0;
  * stride 2, pad 1: output plane o reads input planes 2o-1 .. 2o+1, so
    one plane from the previous rank and none from the next (every slab
    starts at an even plane: the next level divides S);
  * transposed, stride 2, pad 1, output_padding 1: output planes
    [2 d0, 2 d1) read input planes d0 .. d1, so one plane from the next
    rank, then the result is cropped to the rank's planes (the last rank's
    extra plane is the output padding);
  * a block between a slab level and a whole one gathers its input (slab
    to whole) or runs whole and keeps its slab of the output (whole to
    slab);
  * BatchNorm in training: a slab block's statistics, and the sums of its
    backward, are those of the whole volume, over the slab-stats group
    (``stats_group``: every rank of the mesh, the global batch and all of
    D); a whole block's are over the data group alone
    (``batch_stats_group`` around the forward), its input being
    replicated across the space group.

Gradients: the slab blocks' parameters (and the weight nets' in the
cascade) receive this rank's slab's share, summed over the space group by
the train step (``CascadeMVSNet.slab_share_parameters``); the whole
blocks' receive the whole gradient on every rank.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ..nn.blocks import batch_stats_group, conv, norm_act
from .collectives import exchange_halo, gather_tokens, slice_tokens

D_DIM = 2  # [B, C, D, H, W]


def slabbed(depth: int, size: int) -> bool:
    """JAX's rule: a level of ``depth`` planes is cut over a group of
    ``size`` ranks where size divides it (and depth >= size)."""
    return size > 1 and depth % size == 0 and depth >= size


def level_depths(depth: int) -> list:
    """The D of CostRegNet's four levels (three stride-2 halvings)."""
    return [depth >> i for i in range(4)]


def level_slabs(local_depth: int, group) -> list:
    """Which of CostRegNet's four levels run on slabs, for a volume of
    ``local_depth`` planes on each rank of the group."""
    size = dist.get_world_size(group)
    return [slabbed(d, size) for d in level_depths(local_depth * size)]


def stats_group(slab_group, stats_group):
    """The group a slab region's training BatchNorm reduces over: the
    global batch and the whole depth axis, so every rank of the mesh
    (``Mesh.slab_stats_group``). Without ``stats_group`` the slab group
    serves only where it is every rank (one data rank); otherwise this
    raises, since its statistics would cover part of the batch."""
    if slab_group is None or stats_group is not None:
        return stats_group
    if dist.get_world_size(slab_group) != dist.get_world_size():
        raise ValueError(f"a slab group of {dist.get_world_size(slab_group)} of "
                         f"{dist.get_world_size()} ranks needs slab_stats_group "
                         "(Mesh.slab_stats_group): its BatchNorms reduce over every rank")
    return slab_group


def _weights(m, dtype):
    return m.weight.to(dtype), None if m.bias is None else m.bias.to(dtype)


def _conv_slab(x, m: nn.Conv3d, group):
    """A 3x3x3 convolution with pad 1 and stride 1 or 2 of a D slab."""
    if tuple(m.kernel_size) != (3, 3, 3) or tuple(m.padding) != (1, 1, 1) \
            or m.stride[0] not in (1, 2):
        raise ValueError(f"slab convolution of {m}: only 3x3x3, pad 1, stride 1 or 2")
    xh = exchange_halo(x, D_DIM, 1, 1 if m.stride[0] == 1 else 0, group)
    w, b = _weights(m, x.dtype)
    return F.conv3d(xh, w, b, m.stride, (0,) + tuple(m.padding[1:]))


def _deconv_slab(x, m: nn.ConvTranspose3d, group):
    """The 3x3x3 transposed convolution (stride 2, pad 1, output_padding 1)
    of a D slab: this rank's 2n output planes."""
    if tuple(m.kernel_size) != (3, 3, 3) or tuple(m.padding) != (1, 1, 1) \
            or m.stride[0] != 2 or m.output_padding[0] != 1:
        raise ValueError(f"slab transposed convolution of {m}: only 3x3x3, stride 2, "
                         "pad 1, output_padding 1")
    n = x.shape[D_DIM]
    xh = exchange_halo(x, D_DIM, 0, 1, group)
    w, b = _weights(m, x.dtype)
    y = F.conv_transpose3d(xh, w, b, m.stride, m.padding, (0,) + tuple(m.output_padding[1:]))
    return y.narrow(D_DIM, 0, 2 * n)


def run_block(block: nn.Module, x, in_slab: bool, out_slab: bool, group, stats_group):
    """A Conv3dBlock, a Deconv3dBlock or a bare Conv3d between two levels:
    ``x`` is this rank's slab of the input level (``in_slab``) or the
    whole level; returns its slab of the output level (``out_slab``) or
    the whole one."""
    if in_slab and out_slab:
        layer = block if isinstance(block, nn.Conv3d) else block.conv
        if isinstance(layer, nn.ConvTranspose3d):
            y = _deconv_slab(x, layer, group)
        else:
            y = _conv_slab(x, layer, group)
        if isinstance(block, nn.Conv3d):
            return y
        if block.bn is None:
            return torch.relu(y) if block.relu else y
        with batch_stats_group(stats_group):
            return norm_act(y, block.bn, block.relu)
    if in_slab:
        x = gather_tokens(x, D_DIM, group)
    y = conv(x, block) if isinstance(block, nn.Conv3d) else block(x)
    return slice_tokens(y, D_DIM, group) if out_slab else y


def slab_parameters(net, depth: int, size: int) -> list:
    """The parameters of ``net`` (a CostRegNet on a volume of ``depth``
    planes) whose gradient a rank holds one slab's share of: those of the
    blocks that run on slabs (both levels slabbed)."""
    slab = [slabbed(d, size) for d in level_depths(depth)]
    return [p for name, (a, b) in net.LEVELS.items() if slab[a] and slab[b]
            for p in getattr(net, name).parameters()]
