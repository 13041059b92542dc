"""3-D cost-volume regularizers (counterpart of damvsnet_tpu/nn/costreg.py).

CostRegNet, the CasMVSNet 3-D U-Net: three stride-2 encoder levels
(channels x2 each), three transposed-conv decoder levels with additive
skips, and a final 1-channel conv (no BN/ReLU/bias). Reg2d, the
GeoMVSNet-style (1,3,3)-kernel regularizer: strides H and W only, D is
kept, a 1x1x1 head with a bias; a library module that no cascade uses, as
in JAX. Names follow the reference state_dict: conv0..conv6,
conv7/conv9/conv11 (decoders), prob.

Layout: [B, C, D, H, W]; the fused cost volume arrives as a
``channels_last_3d`` view. Where no gradient is needed (serving, the test
CLI, validation) and the U-Net is 8 channels wide there (``cr_base_chs``'s
default), the final ``prob`` conv runs as the hand-written kernel
``ops/kernels/prob_conv.py::prob_conv3d``, which reads that layout as it
is; under autograd, at other widths and with ``plain``, it stays the
library convolution.

``CostRegNet(slab_group=...)``: the depth-slab axis (JAX's ``slab_axis``):
each rank of the group holds one slab of the volume's D axis and every
block, the final ``prob`` conv included, runs through
``parallel/slab.py::run_block``; ``slab_stats_group`` is the group its
BatchNorms take their training statistics over (every rank of the mesh;
it may be left out only where the slab group is every rank). Reg2d is
not slabbed, as in JAX.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.kernels import prob_conv
from ..parallel import slab
from .blocks import Conv3dBlock, Deconv3dBlock, conv


class CostRegNet(nn.Module):
    # each block's (level it reads, level it writes); level i has D / 2^i planes
    LEVELS = {"conv0": (0, 0), "conv1": (0, 1), "conv2": (1, 1), "conv3": (1, 2),
              "conv4": (2, 2), "conv5": (2, 3), "conv6": (3, 3), "conv7": (3, 2),
              "conv9": (2, 1), "conv11": (1, 0), "prob": (0, 0)}

    def __init__(self, in_channels: int, base_channels: int = 8, slab_group=None,
                 slab_stats_group=None):
        super().__init__()
        self.slab_group = slab_group
        self.slab_stats_group = slab.stats_group(slab_group, slab_stats_group)
        c = base_channels
        self.conv0 = Conv3dBlock(in_channels, c, 3, 1, 1)
        self.conv1 = Conv3dBlock(c, 2 * c, 3, 2, 1)
        self.conv2 = Conv3dBlock(2 * c, 2 * c, 3, 1, 1)
        self.conv3 = Conv3dBlock(2 * c, 4 * c, 3, 2, 1)
        self.conv4 = Conv3dBlock(4 * c, 4 * c, 3, 1, 1)
        self.conv5 = Conv3dBlock(4 * c, 8 * c, 3, 2, 1)
        self.conv6 = Conv3dBlock(8 * c, 8 * c, 3, 1, 1)
        self.conv7 = Deconv3dBlock(8 * c, 4 * c, 3, 2, 1, output_padding=1)
        self.conv9 = Deconv3dBlock(4 * c, 2 * c, 3, 2, 1, output_padding=1)
        self.conv11 = Deconv3dBlock(2 * c, c, 3, 2, 1, output_padding=1)
        self.prob = nn.Conv3d(c, 1, 3, padding=1, bias=False)

    def forward(self, x, plain: bool = False):
        """[B, C, D, H, W] -> [B, 1, D, H, W] regularized cost (with a slab
        group: this rank's slabs of both). plain: the library convolution
        for ``prob`` wherever it runs (the cascade's ``plain``)."""
        run = self._runner(x.shape[2], plain)
        conv0 = run("conv0", x)
        conv2 = run("conv2", run("conv1", conv0))
        conv4 = run("conv4", run("conv3", conv2))
        x = run("conv6", run("conv5", conv4))
        x = conv4 + run("conv7", x)
        x = conv2 + run("conv9", x)
        x = conv0 + run("conv11", x)
        return run("prob", x)

    def _runner(self, depth, plain):
        """run(name, x): the named block on x; with a slab group, on this
        rank's slabs of a volume of ``depth`` planes a rank, or whole where
        its level does not divide (``slab.run_block``)."""
        if self.slab_group is None:
            return lambda name, x: (self._prob(x, plain) if name == "prob"
                                    else getattr(self, name)(x))
        slabs = slab.level_slabs(depth, self.slab_group)

        def run(name, x):
            a, b = self.LEVELS[name]
            return slab.run_block(getattr(self, name), x, slabs[a], slabs[b], self.slab_group,
                                  self.slab_stats_group)
        return run

    def _prob(self, x, plain):
        """The ``prob`` conv: the kernel where it applies (the width it is
        built for) unless a gradient is needed (it has no backward) or
        ``plain``."""
        if (plain or self.prob.in_channels != prob_conv.CHANNELS
                or (torch.is_grad_enabled()
                    and (x.requires_grad or self.prob.weight.requires_grad))):
            return conv(x, self.prob)
        return prob_conv.prob_conv3d(x, self.prob.weight)


class Reg2d(nn.Module):
    """[B, C, D, H, W] -> [B, D, H, W]; H and W divisible by 8."""

    def __init__(self, in_channels: int, base_channels: int = 8):
        super().__init__()
        c = base_channels
        k, p, s, op = (1, 3, 3), (0, 1, 1), (1, 2, 2), (0, 1, 1)
        self.conv0 = Conv3dBlock(in_channels, c, k, 1, p)
        self.conv1 = Conv3dBlock(c, 2 * c, k, s, p)
        self.conv2 = Conv3dBlock(2 * c, 2 * c, 3, 1, 1)
        self.conv3 = Conv3dBlock(2 * c, 4 * c, k, s, p)
        self.conv4 = Conv3dBlock(4 * c, 4 * c, 3, 1, 1)
        self.conv5 = Conv3dBlock(4 * c, 8 * c, k, s, p)
        self.conv6 = Conv3dBlock(8 * c, 8 * c, 3, 1, 1)
        self.conv7 = Deconv3dBlock(8 * c, 4 * c, k, s, p, output_padding=op)
        self.conv9 = Deconv3dBlock(4 * c, 2 * c, k, s, p, output_padding=op)
        self.conv11 = Deconv3dBlock(2 * c, c, k, s, p, output_padding=op)
        self.prob = nn.Conv3d(c, 1, 1, bias=True)

    def forward(self, x):
        conv0 = self.conv0(x)
        conv2 = self.conv2(self.conv1(conv0))
        conv4 = self.conv4(self.conv3(conv2))
        x = self.conv6(self.conv5(conv4))
        x = conv4 + self.conv7(x)
        x = conv2 + self.conv9(x)
        x = conv0 + self.conv11(x)
        return conv(x, self.prob)[:, 0]
