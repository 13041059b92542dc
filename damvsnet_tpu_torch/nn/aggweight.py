"""Per-view visibility weight net for adaptive cost aggregation
(counterpart of damvsnet_tpu/nn/aggweight.py).

w_net = Conv3d(C -> 1, 1x1x1, BN, ReLU) -> Conv3d(1 -> 1, 1x1x1, BN, ReLU)
on the squared feature difference volume. The reference also constructs an
unused ``conv0``; it never runs and is omitted.
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
        """[B, C, D, H, W] -> [B, 1, D, H, W] non-negative weights."""
        return self.w_net(x)


def fold_aggweight(net: AggWeightNetVolume):
    """Collapse the net into its affine form
    w(x) = relu(w2 * relu(<x, w1> + b1) + b2), BN running statistics folded
    into the 1x1x1 conv weights — the form the fused cost-volume kernel
    evaluates per voxel. Returns (w1 [C], b1, w2, b2) fp32 tensors on the
    net's device; nothing leaves the device.

    This is the weight net's only form, in training too (the JAX package's
    ``fused_train`` semantics, damvsnet_tpu/model/cascade.py:87-97): the
    fold is differentiable, so gradient reaches the conv weights and the
    BN weight/bias, while the two BNs keep using, and never update, their
    running statistics (the net's forward is never called)."""
    def fold(block):
        bn = block.bn
        s = bn.weight.float() / torch.sqrt(bn.running_var.float() + BN_EPS)
        t = bn.bias.float() - bn.running_mean.float() * s
        return block.conv.weight.float().reshape(-1) * s[0], t[0]

    w1, b1 = fold(net.w_net[0])
    w2, b2 = fold(net.w_net[1])
    return w1, b1, w2[0], b2
