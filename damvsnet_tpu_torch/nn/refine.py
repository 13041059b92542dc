"""Residual depth refinement head (counterpart of damvsnet_tpu/nn/refine.py):
four conv + BN + ReLU layers on concat(image, initial depth) predicting a
depth residual; the cascade's ``refine=True`` adds
``outputs["refined_depth"]``. Names follow the reference's RefineNet
(module.py:594-606): ``conv1``, ``conv2``, ``conv3``, ``res``.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from .blocks import Conv2dBlock


class RefineNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = Conv2dBlock(4, 32, 3, 1, 1)
        self.conv2 = Conv2dBlock(32, 32, 3, 1, 1)
        self.conv3 = Conv2dBlock(32, 32, 3, 1, 1)
        self.res = Conv2dBlock(32, 1, 3, 1, 1)

    def forward(self, img, depth_init, dtype=torch.float32):
        """img [B, H, W, 3] and depth_init [B, H, W], fp32 -> refined depth
        [B, H, W], fp32; the convolutions run in ``dtype``."""
        x = torch.cat([img, depth_init[..., None]], dim=-1).permute(0, 3, 1, 2).to(dtype)
        residual = self.res(self.conv3(self.conv2(self.conv1(x))))
        return depth_init + residual[:, 0]
