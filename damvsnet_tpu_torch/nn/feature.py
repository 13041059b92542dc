"""FPN image feature extractor (counterpart of damvsnet_tpu/nn/feature.py,
arch_mode="fpn").

Stride-4 trunk 8 -> 16 -> 32 channels (k3 / k5-s2 / k5-s2 stacks), then an
FPN top-down pathway (1x1 laterals + nearest x2 upsample, 3x3 heads).
Inputs and outputs are NCHW; run on a ``channels_last`` input every map
stays ``channels_last``, so each output's NHWC permutation is a free view::

    {"stage1": [B, 32, H/4, W/4], "stage2": [B, 16, H/2, W/2], "stage3": [B, 8, H, W]}
"""
from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from .blocks import Conv2dBlock, conv


class FeatureNet(nn.Module):
    def __init__(self, base_channels: int = 8):
        super().__init__()
        b = base_channels
        self.conv0 = nn.Sequential(Conv2dBlock(3, b, 3, 1, 1),
                                   Conv2dBlock(b, b, 3, 1, 1))
        self.conv1 = nn.Sequential(Conv2dBlock(b, 2 * b, 5, 2, 2),
                                   Conv2dBlock(2 * b, 2 * b, 3, 1, 1),
                                   Conv2dBlock(2 * b, 2 * b, 3, 1, 1))
        self.conv2 = nn.Sequential(Conv2dBlock(2 * b, 4 * b, 5, 2, 2),
                                   Conv2dBlock(4 * b, 4 * b, 3, 1, 1),
                                   Conv2dBlock(4 * b, 4 * b, 3, 1, 1))
        self.out1 = nn.Conv2d(4 * b, 4 * b, 1, bias=False)
        self.inner1 = nn.Conv2d(2 * b, 4 * b, 1, bias=True)
        self.inner2 = nn.Conv2d(b, 4 * b, 1, bias=True)
        self.out2 = nn.Conv2d(4 * b, 2 * b, 3, padding=1, bias=False)
        self.out3 = nn.Conv2d(4 * b, b, 3, padding=1, bias=False)

    def forward(self, x):
        conv0 = self.conv0(x)
        conv1 = self.conv1(conv0)
        intra = self.conv2(conv1)
        outputs = {"stage1": conv(intra, self.out1)}
        intra = (F.interpolate(intra, size=conv1.shape[2:], mode="nearest")
                 + conv(conv1, self.inner1))
        outputs["stage2"] = conv(intra, self.out2)
        intra = (F.interpolate(intra, size=conv0.shape[2:], mode="nearest")
                 + conv(conv0, self.inner2))
        outputs["stage3"] = conv(intra, self.out3)
        return outputs
