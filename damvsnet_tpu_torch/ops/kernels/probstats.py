"""Probability-volume statistics: wrapper of csrc/probstats.cu (K2).

Replaces damvsnet_tpu/ops/pallas/probstats.py::prob_volume_stats_pallas:
softmax, soft-argmin depth, the 4-tap-window confidence and the 3-sigma
band in fp32, reading the cost once in its own dtype (fp32 or bf16; the
conversion is exact) and writing prob once. The plain version is
``ops.regression.prob_volume_stats``, which upcasts the cost to fp32 first.
"""
from __future__ import annotations

import ctypes

import torch

from ..regression import prob_volume_stats
from ._common import DTYPE_CODES, check_cuda, check_launch, depth_argument
from .build import load


def _bind(lib):
    fn = lib.probstats_launch
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, i, vp, i, vp, vp, vp, vp, i, i, ctypes.c_longlong, vp]
    fn.restype = i
    return fn


def prob_volume_stats_fused(prob_volume_pre: torch.Tensor,
                            depth_values: torch.Tensor) -> dict:
    """prob_volume_pre [B, D, H, W] fp32 or bf16; depth_values [B, D] or
    [B, D, H, W] fp32. Returns the dict of ``ops.regression.
    prob_volume_stats``, all fp32. CPU tensors run the plain version; CUDA
    tensors launch the kernel or raise."""
    if prob_volume_pre.device.type == "cpu":
        return prob_volume_stats(prob_volume_pre, depth_values)
    name = "prob_volume_stats_fused"
    dev = check_cuda(name, prob_volume_pre, depth_values)
    if prob_volume_pre.dtype not in DTYPE_CODES or prob_volume_pre.dim() != 4:
        raise ValueError(f"{name}: the cost must be a float32 or bfloat16 "
                         f"[B, D, H, W] tensor, got {prob_volume_pre.dtype} "
                         f"{tuple(prob_volume_pre.shape)}")
    cost = prob_volume_pre.contiguous()
    b, d, h, w = cost.shape
    dv, per_pixel = depth_argument(depth_values, b, d, h, w)
    prob = torch.empty(cost.shape, dtype=torch.float32, device=dev)
    depth, conf, sigma = (torch.empty((b, h, w), dtype=torch.float32, device=dev)
                          for _ in range(3))

    fn = _bind(load("probstats"))
    stream = torch.cuda.current_stream(dev).cuda_stream
    prob_volume_stats_fused.launches += 1
    err = fn(cost.data_ptr(), DTYPE_CODES[cost.dtype], dv.data_ptr(), per_pixel,
             prob.data_ptr(), depth.data_ptr(), conf.data_ptr(), sigma.data_ptr(),
             b, d, h * w, stream)
    check_launch(name, err)
    return {"depth": depth, "photometric_confidence": conf, "variance": sigma,
            "prob_volume": prob}


prob_volume_stats_fused.launches = 0
