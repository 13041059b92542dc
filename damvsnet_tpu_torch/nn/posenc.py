"""2-D positional encodings (counterpart of damvsnet_tpu/nn/posenc.py).

``sine_position_encoding``: the LoFTR sine encoding (temp_bug_fix variant)
computed for the actual (H, W): positions 1-based, channel groups of 4
carry (sin x, cos x, sin y, cos y) with div_term = exp(arange(0, d/2, 2) *
(-ln 1e4 / (d/2))), added in the feature's dtype. The table is built once
per (C, H, W, dtype, device) and kept on that device (62,208 x 32 at the
serving stage 1: 8 MB in fp32 that would otherwise cross from pageable
host memory on every call).

``PositionEncodingSuperGlue``: the SuperGlue keypoint-MLP alternative,
normalized pixel positions -> 1x1 convs [2, 32, 64, C] with BN and ReLU,
added to the feature map. A library option: no cascade uses it, as in JAX.

Layout: features NHWC [B, H, W, C], as the FMT takes them.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn as nn

from .blocks import batch_norm, conv, norm_act


@lru_cache(maxsize=8)
def _pe_np(d_model: int, h: int, w: int) -> np.ndarray:
    pe = np.zeros((h, w, d_model), dtype=np.float32)
    y_pos = np.arange(1, h + 1, dtype=np.float32)[:, None]
    x_pos = np.arange(1, w + 1, dtype=np.float32)[None, :]
    div = np.exp(np.arange(0, d_model // 2, 2, dtype=np.float32)
                 * (-math.log(10000.0) / (d_model // 2)))
    for k, dv in enumerate(div):
        pe[:, :, 4 * k + 0] = np.sin(x_pos * dv)
        pe[:, :, 4 * k + 1] = np.cos(x_pos * dv)
        pe[:, :, 4 * k + 2] = np.sin(y_pos * dv)
        pe[:, :, 4 * k + 3] = np.cos(y_pos * dv)
    return pe


@lru_cache(maxsize=8)
def _pe_table(d_model: int, h: int, w: int, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    """The table on ``device`` in ``dtype``; a normal tensor even when first
    built under inference mode, so that a later training forward may use it."""
    with torch.inference_mode(False):
        return torch.from_numpy(_pe_np(d_model, h, w)).to(device=device, dtype=dtype)


def sine_position_encoding(x: torch.Tensor) -> torch.Tensor:
    """x: [B, H, W, C] -> x + PE (broadcast over batch), in x's dtype."""
    _, h, w, c = x.shape
    return x + _pe_table(c, h, w, x.dtype, x.device)[None]


class PositionEncodingSuperGlue(nn.Module):
    """x [B, H, W, C] -> x + MLP(normalized (x, y) of each pixel). The
    positions are built in x's dtype and the MLP runs in fp32 (flax
    promotes them to its fp32 parameters); in ``.train()`` its BNs use the
    batch statistics over (B, H*W) and update their running statistics
    (momentum 0.1, biased variance), as the port's other BNs do."""

    def __init__(self, d_model: int = 32):
        super().__init__()
        self.d_model = d_model
        self.mlp0 = nn.Conv1d(2, 32, 1)
        self.bn0 = batch_norm(1, 32)
        self.mlp1 = nn.Conv1d(32, 64, 1)
        self.bn1 = batch_norm(1, 64)
        self.mlp_out = nn.Conv1d(64, d_model, 1)
        nn.init.zeros_(self.mlp_out.bias)

    def forward(self, x):
        b, h, w, _ = x.shape
        ys = torch.arange(1, h + 1, dtype=x.dtype, device=x.device)
        xs = torch.arange(1, w + 1, dtype=x.dtype, device=x.device)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        kpts = torch.stack([gx - 1, gy - 1], dim=-1).reshape(1, h * w, 2)
        # normalize_keypoints (position_encoding.py:77-84)
        size = torch.tensor([w, h], dtype=x.dtype, device=x.device)
        kpts = (kpts - size / 2) / (size.max() * 0.7)
        y = kpts.float().transpose(1, 2).expand(b, 2, h * w)  # [B, 2, L]
        y = norm_act(conv(y, self.mlp0), self.bn0, relu=True)
        y = norm_act(conv(y, self.mlp1), self.bn1, relu=True)
        enc = conv(y, self.mlp_out)  # [B, C, L]
        return x + enc.transpose(1, 2).reshape(b, h, w, self.d_model)
