"""Plane-sweep sampler and variance cost volume: wrappers of
csrc/sweep_sampler.cu (K4).

K4 replaces damvsnet_tpu/ops/pallas/sweep_sampler.py::sample_bilinear_band
(entry ``plane_sweep_warp_pallas``) in two entries of one kernel body:

  * ``plane_sweep_sample``: one source view's features warped into the
    reference frustum at every depth hypothesis, with 4-tap zero-padded
    bilinear taps, in the source dtype (the TPU kernel's function). Its
    plain version is ``ops.warp.plane_sweep_warp`` cast to the source dtype.
  * ``plane_sweep_variance``: the variance cost volume over the reference
    and all source views in one launch (the TPU sampler together with the
    elementwise epilogue XLA fuses behind it, damvsnet_tpu/ops/costvol.py:
    63-77). The sums are fp32 over the unrounded samples, the variance
    rounded once. Its plain version is ``ops.costvol.variance_cost_volume``
    over ``plane_sweep_warp``. The serving cascade's variance mode calls it
    once per stage. Past 16 source views (one launch's most) it computes
    the same variance over the sampler entry, one launch per view.

The kernel gathers every tap, so unlike the TPU kernel it has no window
budget and returns no overflow flag. Like the TPU kernel it is
inference-only: it has no backward, and the wrappers raise rather than let
autograd see it. Layout: features NHWC [B, H, W, C]; output [B, D, H, W, C]
contiguous.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ..costvol import variance_cost_volume
from ..warp import plane_sweep_warp
from ._common import (DTYPE_CODES, F32, INT, LL, MAX_VIEWS, VP, Entry, counts, pointer_array,
                      prepare_views)

_SAMPLER = Entry("sweep_sampler", "sweep_sampler_launch", VP, LL, VP, VP, INT, VP, INT, INT, INT,
                 INT, INT, INT, F32, F32, F32, F32)
_VARIANCE = Entry("sweep_sampler", "sweep_variance_launch", VP, LL, ctypes.POINTER(VP), LL, INT,
                  VP, VP, INT, VP, INT, INT, INT, INT, INT, INT, F32, F32, F32, F32)


def _no_autograd(name, *tensors):
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the sampler kernel is inference-only (it has "
                           "no backward, as the TPU kernel has none); call it under "
                           "torch.no_grad() or torch.inference_mode()")


@counts(_SAMPLER)
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
    _no_autograd(name, src_fea, src_proj, ref_proj, depth_values)
    # the one view stands in for the reference: the checks are the same
    L = prepare_views(name, src_fea, [src_fea], ref_proj, [src_proj], depth_values,
                      align_corners)
    out = torch.empty((L.b, L.d, L.h, L.w, L.c), dtype=src_fea.dtype, device=L.dev)
    _SAMPLER.launch(L.dev, src_fea.data_ptr(), L.src_bstride, L.geom.data_ptr(), L.dv.data_ptr(),
                    L.per_pixel, out.data_ptr(), L.b, L.d, L.h, L.w, L.c,
                    DTYPE_CODES[src_fea.dtype], *L.affine)
    return out


def _sample_unrounded(src_fea, src_proj, ref_proj, depth_values, align_corners):
    """K4's sampler on the source's exact fp32 upcast: fp32 samples, so the
    variance's sums see them unrounded, as the variance entry's do."""
    return plane_sweep_sample(src_fea.float(), src_proj, ref_proj, depth_values,
                              align_corners)


@counts(_VARIANCE)
def plane_sweep_variance(ref_fea: torch.Tensor, src_feas: Sequence[torch.Tensor],
                         ref_proj: torch.Tensor, src_projs: Sequence[torch.Tensor],
                         depth_values: torch.Tensor,
                         align_corners: bool = False) -> torch.Tensor:
    """The variance cost volume [B,D,H,W,C] in the feature dtype.

    ref_fea [B,H,W,C]; src_feas: V tensors [B,H,W,C] of its dtype (fp32
    or bf16); projs fused [B,4,4]; depth_values [B,D] or [B,D,H,W] fp32.
    CPU tensors run the plain version; CUDA tensors launch K4's variance
    entry once for all views (past 16 views, K4's sampler once per view
    under the same variance), or raise (also when autograd would need a
    gradient: K4 has none)."""
    if ref_fea.device.type == "cpu":
        return variance_cost_volume(ref_fea, src_feas, ref_proj, src_projs, depth_values,
                                    warp=plane_sweep_warp, align_corners=align_corners)
    name = "plane_sweep_variance"
    _no_autograd(name, ref_fea, *src_feas, ref_proj, *src_projs, depth_values)
    if len(src_feas) > MAX_VIEWS:
        return variance_cost_volume(ref_fea, src_feas, ref_proj, src_projs, depth_values,
                                    warp=_sample_unrounded, align_corners=align_corners)
    L = prepare_views(name, ref_fea, src_feas, ref_proj, src_projs, depth_values,
                      align_corners)
    out = torch.empty((L.b, L.d, L.h, L.w, L.c), dtype=ref_fea.dtype, device=L.dev)
    _VARIANCE.launch(L.dev, ref_fea.data_ptr(), L.ref_bstride, pointer_array(src_feas),
                     L.src_bstride, L.v, L.geom.data_ptr(), L.dv.data_ptr(), L.per_pixel,
                     out.data_ptr(), L.b, L.d, L.h, L.w, L.c, DTYPE_CODES[ref_fea.dtype],
                     *L.affine)
    return out
