"""Probability-volume statistics: softmax, soft-argmin depth, photometric
confidence and the 3-sigma band (counterpart of
damvsnet_tpu/ops/regression.py). This is the plain version of the fused
CUDA kernel in ops/kernels/probstats.py.

  * prob_volume = softmax_D(cost_reg)
  * depth       = sum_D p * d                        (soft-argmin)
  * confidence  = sum of p over d in [idx-1, idx+2], idx = clip(trunc(
                  sum_D p * index), 0, D-1)           (4-tap window)
  * sigma       = 3 * sqrt(sum_D p * (d - depth)^2)

All in fp32: a bf16 cost is upcast first (exactly).
"""
from __future__ import annotations

import torch


def _per_pixel(depth_values: torch.Tensor) -> torch.Tensor:
    return depth_values if depth_values.dim() == 4 else depth_values[:, :, None, None]


def depth_regression(p: torch.Tensor, depth_values: torch.Tensor) -> torch.Tensor:
    """Soft-argmin: p [B, D, H, W]; depth_values [B, D] or [B, D, H, W]."""
    return torch.sum(p * _per_pixel(depth_values), dim=1)


def photometric_confidence(prob_volume: torch.Tensor) -> torch.Tensor:
    """4-tap window sum gathered at the soft argmax index, as a masked sum.
    No gradient: the input is detached, as in the reference."""
    prob_volume = prob_volume.detach()
    d = prob_volume.shape[1]
    d_iota = torch.arange(d, dtype=prob_volume.dtype,
                          device=prob_volume.device)[None, :, None, None]
    idx_f = torch.sum(prob_volume * d_iota, dim=1)
    idx = idx_f.to(torch.int32).clamp(0, d - 1)  # trunc, as torch's .long()
    idx = idx[:, None].to(prob_volume.dtype)
    window = ((d_iota >= idx - 1) & (d_iota <= idx + 2)).to(prob_volume.dtype)
    return torch.sum(prob_volume * window, dim=1)


def prob_volume_stats(prob_volume_pre: torch.Tensor, depth_values: torch.Tensor):
    """prob_volume_pre [B, D, H, W] (pre-softmax), fp32 or upcast to it;
    depth_values [B, D] or [B, D, H, W]. Returns dict(depth,
    photometric_confidence, variance (the 3-sigma band), each [B, H, W],
    and prob_volume [B, D, H, W]), fp32."""
    prob_volume = torch.softmax(prob_volume_pre.float(), dim=1)
    dv = _per_pixel(depth_values)
    depth = depth_regression(prob_volume, dv)
    conf = photometric_confidence(prob_volume)
    samp_var = (dv - depth[:, None]) ** 2
    sigma3 = 3.0 * torch.sqrt(torch.sum(samp_var * prob_volume, dim=1))
    return {
        "depth": depth,
        "photometric_confidence": conf,
        "variance": sigma3,
        "prob_volume": prob_volume,
    }
