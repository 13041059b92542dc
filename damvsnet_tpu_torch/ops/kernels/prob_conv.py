"""CostRegNet's Cout=1 ``prob`` convolution: wrapper of csrc/prob_conv.cu.

Replaces no TPU kernel: the JAX package leaves this convolution to XLA.
cuDNN runs it on its legacy fp32 path (no tensor-core engine takes one
output channel in bf16), 19.9 ms of a DTU request; the kernel computes the
same sum, the weight rounded to the input's dtype as ``nn.blocks.conv``
rounds it, fp32 accumulation and one rounding of the output. It has no
backward: ``CostRegNet`` takes it only where no gradient is needed. The
plain version is ``nn.blocks.conv``.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn as nn

from ...nn.blocks import conv
from ._common import DTYPE_CODES, check_cuda, check_launch
from .build import load

CHANNELS = 8


def _bind(lib):
    fn = lib.prob_conv3d_launch
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, i, vp, vp, vp, i, i, i, i, vp]
    fn.restype = i
    return fn


def prob_conv3d(x: torch.Tensor, m: nn.Conv3d) -> torch.Tensor:
    """``conv(x, m)`` for m a Conv3d(8, 1, 3, padding=1, bias=False) and x
    [B, 8, D, H, W] in fp32 or bf16, any strides (channels_last_3d reads
    whole 16-byte vectors). Returns [B, 1, D, H, W] in x's dtype, one
    contiguous buffer. CPU tensors run the plain version; CUDA tensors
    launch the kernel or raise (and raise where a gradient is needed)."""
    if x.device.type == "cpu":
        return conv(x, m)
    name = "prob_conv3d"
    weight = m.weight.to(x.dtype)  # as conv() rounds it
    dev = check_cuda(name, x, weight)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        raise RuntimeError(f"{name}: the kernel has no backward; take conv() under autograd")
    if x.dtype not in DTYPE_CODES or x.dim() != 5 or x.shape[1] != CHANNELS:
        raise ValueError(f"{name}: x must be a float32 or bfloat16 [B, {CHANNELS}, D, H, W] "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    if (tuple(weight.shape) != (1, CHANNELS, 3, 3, 3) or m.bias is not None
            or tuple(m.stride) != (1, 1, 1) or tuple(m.padding) != (1, 1, 1)
            or tuple(m.dilation) != (1, 1, 1) or m.groups != 1):
        raise ValueError(f"{name}: the module must be Conv3d({CHANNELS}, 1, 3, padding=1, "
                         f"bias=False), got {m}")
    b, _, d, h, w = x.shape
    if x.numel() == 0:
        raise ValueError(f"{name}: empty input {tuple(x.shape)}")
    weight = weight.contiguous()
    out = torch.empty((b, 1, d, h, w), dtype=x.dtype, device=dev)
    strides = (ctypes.c_longlong * 5)(*x.stride())
    fn = _bind(load("prob_conv"))
    stream = torch.cuda.current_stream(dev).cuda_stream
    prob_conv3d.launches += 1
    err = fn(x.data_ptr(), DTYPE_CODES[x.dtype], ctypes.addressof(strides), weight.data_ptr(),
             out.data_ptr(), b, d, h, w, stream)
    check_launch(name, err)
    return out


prob_conv3d.launches = 0
