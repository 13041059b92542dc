"""Depth-hypothesis samplers: uniform (stage 1) and uncertainty-aware ADIA
(counterpart of damvsnet_tpu/ops/sampling.py).

  stage 1 (cur_depth is [B, D0]):
     uniform D samples from cur_depth[:,0] to cur_depth[:,-1], broadcast
     over the [H, W] grid (an expanded view: nothing is materialized).

  stage >= 2 (cur_depth [B, 1, H, W], sigma = exp_var [B, 1, H, W]):
     low  = -min(cur_depth, sigma)          (keeps samples positive)
     high = sigma
     step = (high - low) / (D - 1)
     base_i   = cur_depth + low + step*i + eps
     zscore_i = 3 * (low + step*i) / (sigma + eps)
     offset   = softmax_D(zscore)           (adaptive interval reweighting)
     sample_i = base_i + offset_i * step

CasMVSNet's fixed-interval band (``get_cur_depth_range_samples``) and its
dispatcher (``get_depth_range_samples``) are library functions here, as in
the JAX package: no path of either package calls them.
"""
from __future__ import annotations

import torch

EPS = 1e-12


def uniform_depth_samples(depth_values: torch.Tensor, ndepth: int, height: int,
                          width: int) -> torch.Tensor:
    """[B, D0] depth range -> [B, D, H, W] uniform samples (first/last
    entries only), as an expanded view."""
    dmin = depth_values[:, 0]
    dmax = depth_values[:, -1]
    interval = (dmax - dmin) / (ndepth - 1)
    i = torch.arange(ndepth, dtype=depth_values.dtype, device=depth_values.device)
    d = dmin[:, None] + i[None, :] * interval[:, None]
    return d[:, :, None, None].expand(d.shape[0], ndepth, height, width)


def adaptive_depth_samples(cur_depth: torch.Tensor, sigma: torch.Tensor,
                           ndepth: int) -> torch.Tensor:
    """ADIA sampling for stages >= 2. cur_depth, sigma: [B, 1, H, W]
    (previous-stage depth and 3-sigma band at full resolution).
    Returns [B, D, H, W]."""
    low = -torch.minimum(cur_depth, sigma)
    high = sigma
    step = (high - low) / (float(ndepth) - 1)
    i = torch.arange(ndepth, dtype=cur_depth.dtype,
                     device=cur_depth.device).reshape(1, ndepth, 1, 1)
    ramp = low + step * i
    base = cur_depth + ramp + EPS
    zscore = 3.0 * ramp / (sigma + EPS)
    offset = torch.softmax(zscore, dim=1)
    return base + offset * step


def uncertainty_aware_samples(cur_depth: torch.Tensor, sigma: torch.Tensor | None,
                              ndepth: int, height: int, width: int) -> torch.Tensor:
    """Dispatch on stage: [B, D0] -> uniform; [B, 1, H, W] -> ADIA."""
    if cur_depth.dim() == 2:
        return uniform_depth_samples(cur_depth, ndepth, height, width)
    if sigma is None:
        raise ValueError("ADIA sampling needs the previous stage's sigma")
    return adaptive_depth_samples(cur_depth, sigma, ndepth)


def get_cur_depth_range_samples(cur_depth: torch.Tensor, ndepth: int,
                                depth_interval_pixel) -> torch.Tensor:
    """CasMVSNet's fixed-interval sampler for stages >= 2: a uniform band of
    ndepth * interval centered on the previous depth. cur_depth [B, H, W]
    (the interval a scalar or [B, H, W]) -> [B, D, H, W]."""
    lo = cur_depth - ndepth / 2 * depth_interval_pixel
    hi = cur_depth + ndepth / 2 * depth_interval_pixel
    new_interval = (hi - lo) / (ndepth - 1)
    i = torch.arange(ndepth, dtype=cur_depth.dtype,
                     device=cur_depth.device).reshape(1, ndepth, 1, 1)
    return lo[:, None] + i * new_interval[:, None]


def get_depth_range_samples(cur_depth: torch.Tensor, ndepth: int, depth_interval_pixel,
                            height: int, width: int) -> torch.Tensor:
    """Dispatch: [B, D0] -> the uniform sweep; [B, H, W] -> the
    fixed-interval band."""
    if cur_depth.dim() == 2:
        return uniform_depth_samples(cur_depth, ndepth, height, width)
    return get_cur_depth_range_samples(cur_depth, ndepth, depth_interval_pixel)
