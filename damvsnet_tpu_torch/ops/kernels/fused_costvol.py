"""Fused adaptive cost volume: wrapper of csrc/fused_costvol.cu.

Replaces damvsnet_tpu/ops/pallas/fused_costvol.py::fused_adaptive_cost_volume.
Warp, squared difference, the folded AggWeightNet and the sum over views run
in one CUDA kernel; no per-view volume reaches device memory. The kernel
gathers every bilinear tap, so unlike the TPU kernel it has no window
budget and returns no overflow flag.

Layout: features NHWC [B, H, W, C] (free views of ``channels_last``
feature maps), volume [B, D, H, W, C] contiguous — its
``permute(0, 4, 1, 2, 3)`` is a ``channels_last_3d`` view for Conv3d.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ..costvol import build_cost_volume
from ..warp import geom_from_projs, pixel_affine
from ._common import check_cuda, check_launch, depth_argument
from .build import load

SUPPORTED_CHANNELS = (8, 16, 32)
MAX_VIEWS = 16  # kMaxViews in the CUDA source
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def folded_weight_fn(w1, b1, w2, b2):
    """The folded AggWeightNet w(x) = relu(w2 * relu(<x, w1> + b1) + b2)
    on a [..., C] fp32 squared difference -> [..., 1]."""
    def weight_fn(diff_sq):
        s = (diff_sq * w1.float()).sum(-1, keepdim=True)
        return torch.relu(w2 * torch.relu(s + b1) + b2)
    return weight_fn


def fused_adaptive_cost_volume_plain(ref_fea, src_feas, ref_proj, src_projs,
                                     depth_values, w1, b1, w2, b2):
    """The kernel's plain PyTorch version (same inputs, same result)."""
    return build_cost_volume(ref_fea, src_feas, ref_proj, src_projs,
                             depth_values, folded_weight_fn(w1, b1, w2, b2))


def _bind(lib):
    fn = lib.fused_costvol_launch
    vp, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    fn.argtypes = [vp, ll, ctypes.POINTER(vp), ll, i, vp, vp, i, vp, vp,
                   i, i, i, i, i, i, f, f, f, f, vp]
    fn.restype = i
    return fn


def fused_adaptive_cost_volume(ref_fea: torch.Tensor,
                               src_feas: Sequence[torch.Tensor],
                               ref_proj: torch.Tensor,
                               src_projs: Sequence[torch.Tensor],
                               depth_values: torch.Tensor,
                               w1, b1, w2, b2) -> torch.Tensor:
    """Adaptive cost volume [B, D, H, W, C] in the feature dtype.

    ref_fea [B,H,W,C]; src_feas: V tensors [B,H,W,C]; projs fused [B,4,4];
    depth_values [B,D] or [B,D,H,W] fp32; (w1 [C], b1, w2, b2) from
    ``nn.aggweight.fold_aggweight``. CPU tensors run the plain version; CUDA
    tensors launch the kernel or raise."""
    if ref_fea.device.type == "cpu":
        return fused_adaptive_cost_volume_plain(
            ref_fea, src_feas, ref_proj, src_projs, depth_values, w1, b1, w2, b2)
    name = "fused_adaptive_cost_volume"
    dev = check_cuda(name, ref_fea, *src_feas, ref_proj, *src_projs, depth_values)
    if ref_fea.dtype not in _DTYPES:
        raise ValueError(f"{name}: feature dtype {ref_fea.dtype} is not float32 "
                         "or bfloat16")
    b, h, w, c = ref_fea.shape
    v = len(src_feas)
    if c not in SUPPORTED_CHANNELS:
        raise ValueError(f"{name}: C={c} not in {SUPPORTED_CHANNELS}")
    if not 1 <= v <= MAX_VIEWS:
        raise ValueError(f"{name}: {v} source views, supported 1..{MAX_VIEWS}")
    if len(src_projs) != v:
        raise ValueError(f"{name}: {v} source features but {len(src_projs)} "
                         "projections")
    plane = (w * c, c, 1)
    if tuple(ref_fea.stride()[1:]) != plane:
        raise ValueError(f"{name}: the reference [H, W, C] plane must be contiguous")
    src_bstride = src_feas[0].stride(0) if b > 1 else 0
    for s in src_feas:
        if s.dtype != ref_fea.dtype or tuple(s.shape) != (b, h, w, c):
            raise ValueError(f"{name}: source feature {tuple(s.shape)} "
                             f"{s.dtype} does not match the reference "
                             f"{(b, h, w, c)} {ref_fea.dtype}")
        if tuple(s.stride()[1:]) != plane or (b > 1 and s.stride(0) != src_bstride):
            raise ValueError(f"{name}: each source [H, W, C] plane must be "
                             "contiguous, with one batch stride for all views")
    ptrs = [s.data_ptr() for s in src_feas]
    if any(p % 16 for p in ptrs + [ref_fea.data_ptr()]):
        raise ValueError(f"{name}: feature pointers must be 16-byte aligned")
    d = depth_values.shape[1]
    dv, per_pixel = depth_argument(depth_values, b, d, h, w)

    geom = torch.stack([geom_from_projs(sp, ref_proj) for sp in src_projs]).contiguous()
    # built on the device (a fill, never a host copy) so no launch syncs
    scal = [x.float().reshape(1) if torch.is_tensor(x)
            else torch.full((1,), float(x), device=dev)
            for x in (b1, w2, b2, 1.0 / v)]
    params = torch.cat([w1.float().reshape(c), *scal])
    out = torch.empty((b, d, h, w, c), dtype=ref_fea.dtype, device=dev)
    sx, ox = pixel_affine(w)
    sy, oy = pixel_affine(h)

    fn = _bind(load("fused_costvol"))
    stream = torch.cuda.current_stream(dev).cuda_stream
    fused_adaptive_cost_volume.launches += 1
    err = fn(ref_fea.data_ptr(), ref_fea.stride(0) if b > 1 else 0,
             (ctypes.c_void_p * v)(*ptrs), src_bstride, v,
             geom.data_ptr(), dv.data_ptr(), per_pixel, params.data_ptr(),
             out.data_ptr(), b, d, h, w, c, _DTYPES[ref_fea.dtype],
             sx, ox, sy, oy, stream)
    check_launch(name, err)
    return out


fused_adaptive_cost_volume.launches = 0
