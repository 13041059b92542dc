"""3-D cost-volume regularizers (counterpart of damvsnet_tpu/nn/costreg.py).

CostRegNet, the CasMVSNet 3-D U-Net: three stride-2 encoder levels
(channels x2 each), three transposed-conv decoder levels with additive
skips, and a final 1-channel conv (no BN/ReLU/bias). Reg2d, the
GeoMVSNet-style (1,3,3)-kernel regularizer: strides H and W only, D is
kept, a 1x1x1 head with a bias; a library module that no cascade uses, as
in JAX. Names follow the reference state_dict: conv0..conv6,
conv7/conv9/conv11 (decoders), prob.

Layout: [B, C, D, H, W]; the fused cost volume arrives as a
``channels_last_3d`` view.
"""
from __future__ import annotations

import torch.nn as nn

from .blocks import Conv3dBlock, Deconv3dBlock, conv


class CostRegNet(nn.Module):
    def __init__(self, in_channels: int, base_channels: int = 8):
        super().__init__()
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

    def forward(self, x):
        """[B, C, D, H, W] -> [B, 1, D, H, W] regularized cost."""
        conv0 = self.conv0(x)
        conv2 = self.conv2(self.conv1(conv0))
        conv4 = self.conv4(self.conv3(conv2))
        x = self.conv6(self.conv5(conv4))
        x = conv4 + self.conv7(x)
        x = conv2 + self.conv9(x)
        x = conv0 + self.conv11(x)
        return conv(x, self.prob)


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
