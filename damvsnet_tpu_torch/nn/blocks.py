"""Conv / BN / ReLU building blocks (counterpart of damvsnet_tpu/nn/blocks.py).

Conv2d, Conv3d, Deconv2d and Deconv3d blocks with BatchNorm (eps 1e-5,
torch momentum 0.1 == flax 0.9) and ReLU, each switchable as in JAX
(``relu=False`` for the residual blocks' second conv; ``bn=False`` gives
the convolution a bias instead), named ``.conv`` / ``.bn`` as the
reference state_dict names them; the 2-D (transposed) conv blocks of geo
fusion are ``SeqConvBnReLU``, named ``.0`` / ``.1``. ``Hourglass3d`` is
the library's 3-D hourglass (no cascade uses it, as in JAX). Torch's ``ConvTranspose`` with ``output_padding`` is
what the JAX package's ``conv_transpose_torch`` emulates, so the
transposed convolutions here are torch's own.

A convolution runs in the input's dtype (the compute dtype, weights cast
to it). BatchNorm (``norm_act``) follows the JAX ``_NormAct``:

  * eval: folded to one per-channel affine computed in fp32 from the
    running statistics, the result cast back to the compute dtype;
  * training (``bn.training``): batch statistics over every axis but the
    channel, computed in fp32 (flax ``BatchNorm(dtype=float32)``), the
    normalized result cast back to the compute dtype. The running
    statistics are updated with the BIASED batch variance, as flax does;
    torch's own ``F.batch_norm`` would use the unbiased one, a factor
    n/(n-1) apart.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # == flax momentum 0.9


_CONV_FN = {3: F.conv1d, 4: F.conv2d, 5: F.conv3d}


def conv(x: torch.Tensor, m: nn.Conv1d | nn.Conv2d | nn.Conv3d) -> torch.Tensor:
    """Apply a Conv1d/2d/3d module in the input's dtype."""
    w = m.weight.to(x.dtype)
    b = None if m.bias is None else m.bias.to(x.dtype)
    return _CONV_FN[x.dim()](x, w, b, m.stride, m.padding)


def deconv(x: torch.Tensor, m: nn.ConvTranspose2d | nn.ConvTranspose3d) -> torch.Tensor:
    """Apply a ConvTranspose2d/3d module in the input's dtype."""
    w = m.weight.to(x.dtype)
    b = None if m.bias is None else m.bias.to(x.dtype)
    fn = F.conv_transpose2d if x.dim() == 4 else F.conv_transpose3d
    return fn(x, w, b, m.stride, m.padding, m.output_padding)


def norm_act(y: torch.Tensor, bn: nn.modules.batchnorm._BatchNorm,
             relu: bool) -> torch.Tensor:
    """BatchNorm of y (batch statistics in training, the running-statistics
    fold otherwise), in y's dtype, then optionally ReLU."""
    if bn.training:
        return _batch_stats_norm(y, bn, relu)
    s = torch.rsqrt(bn.running_var.float() + BN_EPS)
    t = -bn.running_mean.float() * s
    g = bn.weight.float()
    s, t = s * g, t * g + bn.bias.float()
    shape = (1, -1) + (1,) * (y.dim() - 2)
    if torch.is_grad_enabled() and (y.requires_grad or s.requires_grad):
        out = torch.addcmul(t.view(shape), y, s.view(shape)).to(y.dtype)
    else:  # in y's dtype and memory format, with no fp32 temporary
        out = torch.empty_like(y)
        torch.addcmul(t.view(shape), y, s.view(shape), out=out)
    return out.relu_() if relu else out


def _batch_stats_norm(y, bn, relu):
    """Training-mode BatchNorm: normalize with the fp32 batch statistics,
    then update the running statistics (momentum 0.1, biased variance)."""
    y32 = y.float()
    out = F.batch_norm(y32, None, None, bn.weight.float(), bn.bias.float(),
                       training=True, eps=BN_EPS).to(y.dtype)
    with torch.no_grad():
        dims = [0] + list(range(2, y.dim()))
        var, mean = torch.var_mean(y32, dim=dims, correction=0)
        bn.running_mean.lerp_(mean, BN_MOMENTUM)
        bn.running_var.lerp_(var, BN_MOMENTUM)
        bn.num_batches_tracked.add_(1)
    return torch.relu(out) if relu else out


def batch_norm(nd: int, channels: int):
    cls = {1: nn.BatchNorm1d, 2: nn.BatchNorm2d, 3: nn.BatchNorm3d}[nd]
    return cls(channels, eps=BN_EPS, momentum=BN_MOMENTUM)


def conv_bn_relu(x: torch.Tensor, m: nn.Module,
                 bn: nn.modules.batchnorm._BatchNorm) -> torch.Tensor:
    """A (transposed) convolution module, BN and ReLU."""
    transposed = isinstance(m, nn.modules.conv._ConvTransposeNd)
    y = deconv(x, m) if transposed else conv(x, m)
    return norm_act(y, bn, relu=True)


class _ConvBlock(nn.Module):
    """A (transposed) convolution, then BN and ReLU unless switched off;
    without BN the convolution has a bias (JAX's ``bn=False``)."""
    nd = 2
    transposed = False

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding=0, output_padding=0, relu: bool = True,
                 bn: bool = True):
        super().__init__()
        if self.transposed:
            cls = nn.ConvTranspose2d if self.nd == 2 else nn.ConvTranspose3d
            self.conv = cls(in_channels, out_channels, kernel_size, stride,
                            padding, output_padding, bias=not bn)
        else:
            cls = nn.Conv2d if self.nd == 2 else nn.Conv3d
            self.conv = cls(in_channels, out_channels, kernel_size, stride,
                            padding, bias=not bn)
        self.bn = batch_norm(self.nd, out_channels) if bn else None
        self.relu = relu

    def forward(self, x):
        y = deconv(x, self.conv) if self.transposed else conv(x, self.conv)
        if self.bn is not None:
            return norm_act(y, self.bn, self.relu)
        return torch.relu(y) if self.relu else y


class Conv2dBlock(_ConvBlock):
    """Conv2d + BN + ReLU. Parity: models/module.py:28-68."""
    nd = 2


class Conv3dBlock(_ConvBlock):
    """Conv3d + BN + ReLU. Parity: models/module.py:117-159."""
    nd = 3


class Deconv2dBlock(_ConvBlock):
    """ConvTranspose2d + BN + ReLU. Parity: models/module.py:71-115."""
    nd = 2
    transposed = True


class Deconv3dBlock(_ConvBlock):
    """ConvTranspose3d + BN + ReLU. Parity: models/module.py:161-202."""
    nd = 3
    transposed = True


class Hourglass3d(nn.Module):
    """3-D hourglass with 1x1x1 redirect skips (counterpart of
    damvsnet_tpu/nn/blocks.py:227; names as there). [B, C, D, H, W] ->
    the same shape; D, H, W divisible by 4."""

    def __init__(self, channels: int):
        super().__init__()
        c = channels
        self.conv1a = Conv3dBlock(c, 2 * c, 3, 2, 1)
        self.conv1b = Conv3dBlock(2 * c, 2 * c, 3, 1, 1)
        self.conv2a = Conv3dBlock(2 * c, 4 * c, 3, 2, 1)
        self.conv2b = Conv3dBlock(4 * c, 4 * c, 3, 1, 1)
        self.dconv2 = Deconv3dBlock(4 * c, 2 * c, 3, 2, 1, output_padding=1, relu=False)
        self.redir2 = Conv3dBlock(2 * c, 2 * c, 1, 1, 0, relu=False)
        self.dconv1 = Deconv3dBlock(2 * c, c, 3, 2, 1, output_padding=1, relu=False)
        self.redir1 = Conv3dBlock(c, c, 1, 1, 0, relu=False)

    def forward(self, x):
        conv1 = self.conv1b(self.conv1a(x))
        conv2 = self.conv2b(self.conv2a(conv1))
        dconv2 = torch.relu(self.dconv2(conv2) + self.redir2(conv1))
        return torch.relu(self.dconv1(dconv2) + self.redir1(x))


class SeqConvBnReLU(nn.Sequential):
    """A (transposed) conv + BN + ReLU named as the reference's
    ``nn.Sequential`` blocks name it: ``.0`` the convolution, ``.1`` BN."""

    def forward(self, x):
        return conv_bn_relu(x, self[0], self[1])
