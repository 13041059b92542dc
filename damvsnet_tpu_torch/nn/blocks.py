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
    n/(n-1) apart. Inside ``batch_stats_group(group)`` (a process group)
    the statistics are those of the global batch, the union of the group's
    batches (GSPMD's reduction over the 'data' axis in the JAX package):
    ``_SyncedBatchNorm`` gathers each rank's count, fp64 mean and M2 in one
    all-gather and combines them by Chan's formula, which keeps the
    two-pass variance's accuracy; its backward all-reduces the two fp64
    per-channel sums the input's gradient needs. ``nn.SyncBatchNorm``
    is not used: it updates the running variance with the unbiased
    variance.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.distributed as dist
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


_STATS_GROUP = contextvars.ContextVar("batch_stats_group", default=None)


@contextlib.contextmanager
def batch_stats_group(group):
    """Training-mode BatchNorm inside the block takes its batch statistics
    over every rank of ``group`` (a data group; None: this rank's batch
    alone). The group is read when a BN runs forward; its backward keeps
    it."""
    token = _STATS_GROUP.set(group)
    try:
        yield
    finally:
        _STATS_GROUP.reset(token)


def _batch_stats_norm(y, bn, relu):
    """Training-mode BatchNorm: normalize with the fp32 batch statistics,
    then update the running statistics (momentum 0.1, biased variance)."""
    y32 = y.float()
    group = _STATS_GROUP.get()
    if group is None:
        out = F.batch_norm(y32, None, None, bn.weight.float(), bn.bias.float(),
                           training=True, eps=BN_EPS).to(y.dtype)
        with torch.no_grad():
            var, mean = torch.var_mean(y32, dim=[0] + list(range(2, y.dim())), correction=0)
    else:
        out, mean, var = _SyncedBatchNorm.apply(y32, bn.weight.float(), bn.bias.float(),
                                                group)
        out = out.to(y.dtype)
    with torch.no_grad():
        bn.running_mean.lerp_(mean, BN_MOMENTUM)
        bn.running_var.lerp_(var, BN_MOMENTUM)
        bn.num_batches_tracked.add_(1)
    return torch.relu(out) if relu else out


class _SyncedBatchNorm(torch.autograd.Function):
    """BatchNorm of fp32 ``x`` [B, C, ...] over the union of the group's
    batches. Returns (out, mean, biased var); the statistics carry no
    gradient of their own (they reach the input through ``out``)."""

    @staticmethod
    def forward(ctx, x, weight, bias, group):
        dims = [0] + list(range(2, x.dim()))
        shape = (1, -1) + (1,) * (x.dim() - 2)
        c = x.shape[1]
        n_l = x.numel() // c
        # this rank's count, mean and M2 (two-pass), summed in fp64
        mean_l = x.sum(dims, dtype=torch.float64) / n_l
        m2_l = (x - mean_l.float().view(shape)).square().sum(dims, dtype=torch.float64)
        packed = torch.cat([torch.full((1,), float(n_l), dtype=torch.float64, device=x.device),
                            mean_l, m2_l])
        parts = [torch.empty_like(packed) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, packed, group=group)
        stats = torch.stack(parts)  # [ranks, 1 + 2C]: count, mean, M2
        n, means, m2 = stats[:, :1], stats[:, 1:1 + c], stats[:, 1 + c:]
        total = n.sum()
        mean = (n * means).sum(0) / total
        var = (m2.sum(0) + (n * (means - mean) ** 2).sum(0)) / total
        mean, invstd = mean.float(), torch.rsqrt(var + BN_EPS).float()
        out = (x - mean.view(shape)) * (invstd * weight).view(shape) + bias.view(shape)
        ctx.save_for_backward(x, weight, mean, invstd, total)
        ctx.group = group
        var = var.float()
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, grad_out, _grad_mean, _grad_var):
        x, weight, mean, invstd, total = ctx.saved_tensors
        dims = [0] + list(range(2, x.dim()))
        shape = (1, -1) + (1,) * (x.dim() - 2)
        xmu = x - mean.view(shape)
        # this rank's sums, in fp64; DDP averages the parameters' gradients
        sum_dy = grad_out.sum(dims, dtype=torch.float64)
        sum_dy_xmu = (grad_out * xmu).sum(dims, dtype=torch.float64)
        # the input's gradient needs the sums over the global batch
        sums = torch.cat([sum_dy, sum_dy_xmu])
        dist.all_reduce(sums, group=ctx.group)
        mean_dy, mean_dy_xmu = (sums / total).float().chunk(2)
        # dx = invstd w (dy - E[dy] - (x - mean) invstd^2 E[dy (x - mean)])
        k = invstd * invstd * mean_dy_xmu
        grad_x = (grad_out - mean_dy.view(shape) - xmu * k.view(shape)) \
            * (invstd * weight).view(shape)
        return grad_x, sum_dy_xmu.float() * invstd, sum_dy.float(), None


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
