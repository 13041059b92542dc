"""Image feature extractor (counterpart of damvsnet_tpu/nn/feature.py).

Stride-4 trunk 8 -> 16 -> 32 channels (k3 / k5-s2 / k5-s2 stacks), then,
by ``arch_mode``:

  * "fpn": a top-down pathway (1x1 laterals + nearest x2 upsample, 3x3
    heads);
  * "unet": a U-Net decoder of two ``DeConv2dFuse`` (deconv x2, skip
    concat, conv) with 1x1 heads. As in JAX, the heads ``out2`` / ``out3``
    have no compute dtype: they run in fp32, so under bf16 the stage-2 and
    stage-3 features come out fp32.

Inputs and outputs are NCHW; run on a ``channels_last`` input every map
stays ``channels_last``, so each output's NHWC permutation is a free view::

    {"stage1": [B, 32, H/4, W/4], "stage2": [B, 16, H/2, W/2], "stage3": [B, 8, H, W]}
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .blocks import Conv2dBlock, Deconv2dBlock, conv


class DeConv2dFuse(nn.Module):
    """Deconv x2 + skip concat + conv (reference module.py:334-352; names
    ``deconv`` and ``conv``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3):
        super().__init__()
        self.deconv = Deconv2dBlock(in_channels, out_channels, kernel_size, 2, 1,
                                    output_padding=1)
        self.conv = Conv2dBlock(2 * out_channels, out_channels, kernel_size, 1, 1)

    def forward(self, x_pre, x):
        return self.conv(torch.cat([self.deconv(x), x_pre], dim=1))


class FeatureNet(nn.Module):
    def __init__(self, base_channels: int = 8, arch_mode: str = "fpn"):
        super().__init__()
        if arch_mode not in ("fpn", "unet"):
            raise ValueError(f"arch_mode {arch_mode!r} is neither 'fpn' nor 'unet'")
        self.arch_mode = arch_mode
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
        if arch_mode == "unet":
            self.deconv1 = DeConv2dFuse(4 * b, 2 * b, 3)
            self.deconv2 = DeConv2dFuse(2 * b, b, 3)
            self.out2 = nn.Conv2d(2 * b, 2 * b, 1, bias=False)
            self.out3 = nn.Conv2d(b, b, 1, bias=False)
            return
        self.inner1 = nn.Conv2d(2 * b, 4 * b, 1, bias=True)
        self.inner2 = nn.Conv2d(b, 4 * b, 1, bias=True)
        self.out2 = nn.Conv2d(4 * b, 2 * b, 3, padding=1, bias=False)
        self.out3 = nn.Conv2d(4 * b, b, 3, padding=1, bias=False)

    def forward(self, x):
        conv0 = self.conv0(x)
        conv1 = self.conv1(conv0)
        intra = self.conv2(conv1)
        outputs = {"stage1": conv(intra, self.out1)}
        if self.arch_mode == "unet":
            intra = self.deconv1(conv1, intra)
            outputs["stage2"] = conv(intra.float(), self.out2)
            intra = self.deconv2(conv0, intra)
            outputs["stage3"] = conv(intra.float(), self.out3)
            return outputs
        intra = (F.interpolate(intra, size=conv1.shape[2:], mode="nearest")
                 + conv(conv1, self.inner1))
        outputs["stage2"] = conv(intra, self.out2)
        intra = (F.interpolate(intra, size=conv0.shape[2:], mode="nearest")
                 + conv(conv0, self.inner2))
        outputs["stage3"] = conv(intra, self.out3)
        return outputs
