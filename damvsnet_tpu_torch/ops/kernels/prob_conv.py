"""CostRegNet's Cout=1 ``prob`` convolution: wrapper of csrc/prob_conv.cu.

Replaces no TPU kernel: the JAX package leaves this convolution to XLA.
cuDNN runs it on its legacy fp32 path (no tensor-core engine takes one
output channel in bf16), 19.9 ms of a DTU request; the kernel computes the
same sum, the weight rounded to the input's dtype as ``nn.blocks.conv``
rounds it, fp32 accumulation and one rounding of the output. It has no
backward: ``CostRegNet`` takes it only where no gradient is needed. The
plain version is ``F.conv3d`` of that rounded weight.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._common import DTYPE_CODES, INT, VP, Entry, check_cuda, counts

CHANNELS = 8
WEIGHT_SHAPE = (1, CHANNELS, 3, 3, 3)

_K5 = Entry("prob_conv", "prob_conv3d_launch", VP, INT, VP, VP, VP, INT, INT, INT, INT)


@counts(_K5)
def prob_conv3d(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``F.conv3d(x, weight.to(x.dtype), padding=1)`` for a weight
    [1, 8, 3, 3, 3] (fp32 or bf16; no bias) and x [B, 8, D, H, W] in fp32
    or bf16, any strides (channels_last_3d reads whole 16-byte vectors).
    Returns [B, 1, D, H, W] in x's dtype, one contiguous buffer. CPU
    tensors run the plain version; CUDA tensors launch the kernel or raise
    (and raise where a gradient is needed)."""
    if x.device.type == "cpu":
        return F.conv3d(x, weight.to(x.dtype), padding=1)
    name = "prob_conv3d"
    dev = check_cuda(name, x, weight)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        raise RuntimeError(f"{name}: the kernel has no backward; take conv() under autograd")
    if x.dtype not in DTYPE_CODES or x.dim() != 5 or x.shape[1] != CHANNELS:
        raise ValueError(f"{name}: x must be a float32 or bfloat16 [B, {CHANNELS}, D, H, W] "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    if weight.dtype not in DTYPE_CODES or tuple(weight.shape) != WEIGHT_SHAPE:
        raise ValueError(f"{name}: the weight must be a float32 or bfloat16 {WEIGHT_SHAPE} "
                         f"tensor, got {weight.dtype} {tuple(weight.shape)}")
    if x.numel() == 0:
        raise ValueError(f"{name}: empty input {tuple(x.shape)}")
    b, _, d, h, w = x.shape
    weight = weight.to(x.dtype).contiguous()  # as conv() rounds it
    out = torch.empty((b, 1, d, h, w), dtype=x.dtype, device=dev)
    strides = (ctypes.c_longlong * 5)(*x.stride())
    _K5.launch(dev, x.data_ptr(), DTYPE_CODES[x.dtype], ctypes.addressof(strides),
               weight.data_ptr(), out.data_ptr(), b, d, h, w)
    return out
