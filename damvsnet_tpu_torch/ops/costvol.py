"""Cost-volume aggregation (counterpart of damvsnet_tpu/ops/costvol.py).

  * ``build_cost_volume``, mode "adaptive" (the plain version of the fused
    CUDA kernel in ops/kernels/fused_costvol.py):
        diff_v = (ref - warp_v)^2
        w_v    = weight_fn(diff_v)                  (AggWeightNetVolume)
        agg    = sum_v (w_v + 1) * diff_v / (N - 1)
  * ``variance_cost_volume``, mode "variance" (over ``plane_sweep_warp``,
    the plain version of K4's variance entry in
    ops/kernels/sweep_sampler.py): the variance over the N volumes
    {ref, warp_v}, the reference replicated over D: E[f^2] - E[f]^2.

The sums run in fp32 whatever the feature dtype, and the result is cast
to the feature dtype once, as the fused kernel does (the JAX package's
variance mode rounds every partial sum to bf16 in bf16; ROADMAP Queue 3).
One warped volume at a time is alive. Layout: features NHWC; the volume
[B, D, H, W, C] contiguous.

Both are the non-fused training step's cost volumes, under autograd over
``plane_sweep_warp`` (its sampling coordinates detached). With a bf16
compute dtype the warp and the sums stay fp32 (the warp reads the bf16
features exactly); the cascade hands the weight net the squared difference
rounded to the compute dtype, as the JAX package's weight net convolves it
under its compute-dtype scope, and the net's bf16 weights scale the fp32
difference in fp32. The forward still holds one warped volume at a time;
for the backward, autograd keeps per view the fp32 difference (variance:
the sample) and, adaptive, its square and the weight net's input.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from .warp import plane_sweep_warp


def build_cost_volume(ref_fea: torch.Tensor, src_feas: Sequence[torch.Tensor],
                      ref_proj: torch.Tensor, src_projs: Sequence[torch.Tensor],
                      depth_values: torch.Tensor,
                      weight_fn: Callable[[torch.Tensor], torch.Tensor],
                      align_corners: bool = False) -> torch.Tensor:
    """ref_fea [B,H,W,C]; src_feas: list of [B,H,W,C]; projs fused [B,4,4];
    depth_values [B,D] or [B,D,H,W]; weight_fn maps the fp32 [B,D,H,W,C]
    squared difference to [B,D,H,W,1] weights; align_corners: the warp's
    grid un-normalization. Returns [B,D,H,W,C] in the feature dtype."""
    ref_volume = ref_fea.float()[:, None]
    vol = None
    for src_fea, src_proj in zip(src_feas, src_projs):
        warped = plane_sweep_warp(src_fea, src_proj, ref_proj, depth_values, align_corners)
        diff_sq = (ref_volume - warped) ** 2
        contrib = (weight_fn(diff_sq) + 1.0) * diff_sq
        vol = contrib if vol is None else vol + contrib
    return (vol / len(src_feas)).to(ref_fea.dtype)


def variance_cost_volume(ref_fea: torch.Tensor, src_feas: Sequence[torch.Tensor],
                         ref_proj: torch.Tensor, src_projs: Sequence[torch.Tensor],
                         depth_values: torch.Tensor, warp: Callable = plane_sweep_warp,
                         align_corners: bool = False) -> torch.Tensor:
    """Shapes as ``build_cost_volume``; warp(src_fea, src_proj, ref_proj,
    depth_values, align_corners) -> [B,D,H,W,C] in fp32 or the feature
    dtype: ``ops.warp.plane_sweep_warp`` (the plain version of the kernel
    ``ops.kernels.sweep_sampler.plane_sweep_variance``) or the sampler
    kernel ``plane_sweep_sample``. The fp32 sums take a bf16 warp as it is
    (a bf16 product is exact in fp32), so no fp32 copy of it is made.
    Returns [B,D,H,W,C] in the feature dtype."""
    ref_volume = ref_fea.float()[:, None]
    vol, sq = ref_volume, ref_volume ** 2  # broadcast over D by the first view
    for src_fea, src_proj in zip(src_feas, src_projs):
        warped = warp(src_fea, src_proj, ref_proj, depth_values, align_corners)
        vol = vol + warped
        sq = torch.addcmul(sq, warped, warped)
    n = len(src_feas) + 1
    return (sq / n - (vol / n) ** 2).to(ref_fea.dtype)
