"""Per-view visibility weight net for adaptive cost aggregation
(counterpart of damvsnet_tpu/nn/aggweight.py).

w_net = Conv3d(C -> 1, 1x1x1, BN, ReLU) -> Conv3d(1 -> 1, 1x1x1, BN, ReLU)
on the squared feature difference volume. The reference also constructs an
unused ``conv0``; it never runs and is omitted.

The net has two forms:

  * the module's ``forward``, the non-fused training step's weight net (the
    JAX package's default, ``fused_train=False``): in ``.train()`` its two
    1-channel BNs normalize with batch statistics and update their running
    statistics on every call, once per source view, as flax's chained
    updates do;
  * ``fold_aggweight``, the affine form the fused cost-volume kernel K1
    evaluates per voxel, for serving and for ``fused_train``.

``AggWeightNetVolume2`` is the AA-RMVSNet-style alternative (reference
module.py:567-591): a 3x3x3 stem, a 1x1x1 residual pair and a 1x1x1 head;
a library module that no cascade uses, as in JAX.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from .blocks import BN_EPS, Conv3dBlock


class AggWeightNetVolume(nn.Module):
    def __init__(self, in_channels: int):
        super().__init__()
        self.w_net = nn.Sequential(Conv3dBlock(in_channels, 1, 1, 1, 0),
                                   Conv3dBlock(1, 1, 1, 1, 0))

    def forward(self, x):
        """The [B, D, H, W, C] squared difference that ``build_cost_volume``'s
        ``weight_fn`` receives -> [B, D, H, W, 1] non-negative weights, in
        x's dtype. The NCDHW permutation is a channels_last_3d view, so no
        copy is made."""
        return self.w_net(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)


class AggWeightNetVolume2(nn.Module):
    def __init__(self, in_channels: int):
        super().__init__()
        self.conv0 = Conv3dBlock(in_channels, 1, 3, 1, 1)
        self.res0 = Conv3dBlock(1, 1, 1, 1, 0)
        self.res1 = Conv3dBlock(1, 1, 1, 1, 0)
        self.conv1 = Conv3dBlock(1, 1, 1, 1, 0)

    def forward(self, x):
        """[B, D, H, W, C] -> [B, D, H, W, 1] non-negative weights."""
        stem = self.conv0(x.permute(0, 4, 1, 2, 3))
        out = self.res1(self.res0(stem)) + stem
        return self.conv1(out).permute(0, 2, 3, 4, 1)


def fold_aggweight(net: AggWeightNetVolume):
    """Collapse the net into its affine form
    w(x) = relu(w2 * relu(<x, w1> + b1) + b2), BN running statistics folded
    into the 1x1x1 conv weights — the form the fused cost-volume kernel
    evaluates per voxel. Returns (w1 [C], b1, w2, b2) fp32 tensors on the
    net's device; nothing leaves the device.

    The form for serving, and for training with ``fused_train`` (the JAX
    package's semantics, damvsnet_tpu/model/cascade.py:87-97): the fold is
    differentiable, so gradient reaches the conv weights and the BN
    weight/bias, while the two BNs keep using, and never update, their
    running statistics (the net's forward is not called)."""
    def fold(block):
        bn = block.bn
        s = bn.weight.float() / torch.sqrt(bn.running_var.float() + BN_EPS)
        t = bn.bias.float() - bn.running_mean.float() * s
        return block.conv.weight.float().reshape(-1) * s[0], t[0]

    w1, b1 = fold(net.w_net[0])
    w2, b2 = fold(net.w_net[1])
    return w1, b1, w2[0], b2
