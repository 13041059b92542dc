"""Adaptive cost-volume aggregation (counterpart of
damvsnet_tpu/ops/costvol.py, mode="adaptive"). This is the plain version
of the fused CUDA kernel in ops/kernels/fused_costvol.py:

    diff_v = (ref - warp_v)^2
    w_v    = weight_fn(diff_v)                  (AggWeightNetVolume)
    agg    = sum_v (w_v + 1) * diff_v / (N - 1)

The sum runs in fp32 whatever the feature dtype, and the result is cast
to the feature dtype, as the kernel does. One warped volume at a time is
alive. Layout: features NHWC; the volume [B, D, H, W, C].
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from .warp import plane_sweep_warp


def build_cost_volume(ref_fea: torch.Tensor, src_feas: Sequence[torch.Tensor],
                      ref_proj: torch.Tensor, src_projs: Sequence[torch.Tensor],
                      depth_values: torch.Tensor,
                      weight_fn: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """ref_fea [B,H,W,C]; src_feas: list of [B,H,W,C]; projs fused [B,4,4];
    depth_values [B,D] or [B,D,H,W]; weight_fn maps the fp32 [B,D,H,W,C]
    squared difference to [B,D,H,W,1] weights. Returns [B,D,H,W,C] in the
    feature dtype."""
    ref_volume = ref_fea.float()[:, None]
    vol = None
    for src_fea, src_proj in zip(src_feas, src_projs):
        warped = plane_sweep_warp(src_fea, src_proj, ref_proj, depth_values)
        diff_sq = (ref_volume - warped) ** 2
        contrib = (weight_fn(diff_sq) + 1.0) * diff_sq
        vol = contrib if vol is None else vol + contrib
    return (vol / len(src_feas)).to(ref_fea.dtype)
