"""Plane-sweep bilinear sampler: wrapper of csrc/sweep_sampler.cu (K4).

K4 replaces damvsnet_tpu/ops/pallas/sweep_sampler.py::sample_bilinear_band
(entry ``plane_sweep_warp_pallas``): one source view's features warped into
the reference frustum at every depth hypothesis, with 4-tap zero-padded
bilinear taps, in the source dtype. The variance cost volume calls it once
per source view and stage. The kernel gathers every tap, so unlike the TPU
kernel it has no window budget and returns no overflow flag. Like the TPU
kernel it is inference-only: it has no backward, and the wrapper raises
rather than let autograd see it.

The plain version is ``ops.warp.plane_sweep_warp`` (fp32), cast to the
source dtype. Layout: features NHWC [B, H, W, C]; output [B, D, H, W, C]
contiguous.
"""
from __future__ import annotations

import ctypes

import torch

from ..warp import geom_from_projs, pixel_affine, plane_sweep_warp
from ._common import (DTYPE_CODES, SUPPORTED_CHANNELS, check_cuda, check_launch,
                      check_plane, depth_argument)
from .build import load


def _bind(lib):
    fn = lib.sweep_sampler_launch
    vp, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    fn.argtypes = [vp, ll, vp, vp, i, vp, i, i, i, i, i, i, f, f, f, f, vp]
    fn.restype = i
    return fn


def plane_sweep_sample(src_fea: torch.Tensor, src_proj: torch.Tensor,
                       ref_proj: torch.Tensor, depth_values: torch.Tensor,
                       align_corners: bool = False) -> torch.Tensor:
    """src_fea [B,H,W,C]; projs fused [B,4,4]; depth_values [B,D] or
    [B,D,H,W] fp32. Returns [B,D,H,W,C] in the source dtype. CPU tensors
    run the plain version; CUDA tensors launch K4 or raise (also when
    autograd would need a gradient: K4 has none)."""
    if src_fea.device.type == "cpu":
        return plane_sweep_warp(src_fea, src_proj, ref_proj, depth_values,
                                align_corners).to(src_fea.dtype)
    name = "plane_sweep_sample"
    dev = check_cuda(name, src_fea, src_proj, ref_proj, depth_values)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (src_fea, src_proj, ref_proj, depth_values)):
        raise RuntimeError(f"{name}: the sampler kernel is inference-only (it has "
                           "no backward, as the TPU kernel has none); call it under "
                           "torch.no_grad() or torch.inference_mode()")
    if src_fea.dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: feature dtype {src_fea.dtype} is not float32 "
                         "or bfloat16")
    b, h, w, c = src_fea.shape
    if c not in SUPPORTED_CHANNELS:
        raise ValueError(f"{name}: C={c} not in {SUPPORTED_CHANNELS}")
    check_plane(name, h, w, c)
    if tuple(src_fea.stride()[1:]) != (w * c, c, 1):
        raise ValueError(f"{name}: the source [H, W, C] plane must be contiguous")
    if src_fea.data_ptr() % 16:
        raise ValueError(f"{name}: the feature pointer must be 16-byte aligned")
    d = depth_values.shape[1]
    dv, per_pixel = depth_argument(depth_values, b, d, h, w)
    geom = geom_from_projs(src_proj, ref_proj).contiguous()
    out = torch.empty((b, d, h, w, c), dtype=src_fea.dtype, device=dev)

    fn = _bind(load("sweep_sampler"))
    stream = torch.cuda.current_stream(dev).cuda_stream
    plane_sweep_sample.launches += 1
    err = fn(src_fea.data_ptr(), src_fea.stride(0) if b > 1 else 0, geom.data_ptr(),
             dv.data_ptr(), per_pixel, out.data_ptr(), b, d, h, w, c,
             DTYPE_CODES[src_fea.dtype], *pixel_affine(w, align_corners),
             *pixel_affine(h, align_corners), stream)
    check_launch(name, err)
    return out


plane_sweep_sample.launches = 0
