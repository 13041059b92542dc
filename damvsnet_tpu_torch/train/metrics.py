"""Depth-map metrics and scalar averaging; counterpart of
damvsnet_tpu/train/metrics.py (reference utils.py:103-159): per-image-mean
threshold metrics, banded absolute depth errors, DictAverageMeter."""
from __future__ import annotations

import torch


def _masked_mean_per_image(value, mask):
    """Mean over masked pixels per image, then over the batch
    (utils.py:126-137 wrapper semantics)."""
    m = mask.to(value.dtype)
    num = torch.sum(value * m, dim=(1, 2))
    den = torch.clamp(torch.sum(m, dim=(1, 2)), min=1.0)
    return torch.mean(num / den)


def thres_metrics(depth_est, depth_gt, mask, thres: float):
    """Fraction of masked pixels with abs error > thres (utils.py:139-148)."""
    err = (depth_est - depth_gt).abs()
    return _masked_mean_per_image((err > thres).to(depth_est.dtype), mask)


def abs_depth_error_metrics(depth_est, depth_gt, mask, thres_band=None):
    """Mean absolute depth error over masked pixels, optionally only those
    whose error lies in [lo, hi) (utils.py:151-159)."""
    err = (depth_est - depth_gt).abs()
    m = mask
    if thres_band is not None:
        lo, hi = thres_band
        m = m & (err >= lo) & (err < hi)
    return _masked_mean_per_image(err, m)


class DictAverageMeter:
    """Running mean of scalar dicts (utils.py:103-122)."""

    def __init__(self):
        self.data = {}
        self.count = 0

    def update(self, new_input: dict):
        self.count += 1
        for k, v in new_input.items():
            self.data[k] = self.data.get(k, 0.0) + float(v)

    def mean(self):
        return {k: v / self.count for k, v in self.data.items()}
