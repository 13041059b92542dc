"""Entropy-family losses (TransMVSNet lineage); counterpart of
damvsnet_tpu/losses/entropy.py (reference models/module.py:745-851):

  * info_entropy_loss: the masked mean entropy of the probability volume;
  * entropy_loss: cross-entropy against the one-hot index of the hypothesis
    nearest the ground truth, and the winner-take-all depth map;
  * focal_loss_bld: the staged entropy loss, and BlendedMVS's EPE, <1px and
    <3px metrics on depth errors scaled by depth_interval * 192/128.

Layouts: probability volumes [B, D, H, W]; depth maps and masks [B, H, W];
depth_values [B, D] or [B, D, H, W].
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .supervised import masked_smooth_l1


def info_entropy_loss(prob_volume, prob_volume_pre, mask):
    """Masked mean entropy of the probability volume (module.py:745-752)."""
    log_sm = torch.log_softmax(prob_volume_pre, dim=1)
    valid = mask.sum(dim=(1, 2)) + 1e-6
    entropy = -(prob_volume * log_sm).sum(dim=1)  # [B,H,W]
    masked = (mask * entropy).sum(dim=(1, 2))
    return torch.mean(masked / valid)


def entropy_loss(prob_volume, depth_gt, mask, depth_values):
    """Cross-entropy against the nearest-hypothesis one-hot GT index.

    prob_volume [B,D,H,W]; depth_gt [B,H,W]; mask [B,H,W] float 0/1;
    depth_values [B,D] or [B,D,H,W]. Returns (masked_ce, wta_depth_map).
    """
    b, d, h, w = prob_volume.shape
    valid_count = mask.sum(dim=(1, 2)) + 1e-6
    dv = (depth_values if depth_values.dim() == 4
          else depth_values[:, :, None, None].expand(b, d, h, w))
    gt_index = torch.argmin((dv - depth_gt[:, None]).abs(), dim=1)  # [B,H,W]
    # invalid pixels take index 0, rounded like the reference
    gt_index = torch.round(mask * gt_index.to(mask.dtype)).long()
    gt_onehot = F.one_hot(gt_index, d).permute(0, 3, 1, 2).to(prob_volume.dtype)
    ce = -(gt_onehot * torch.log(prob_volume + 1e-6)).sum(dim=1)  # [B,H,W]
    masked_ce = torch.mean((mask * ce).sum(dim=(1, 2)) / valid_count)
    wta_index = torch.argmax(prob_volume, dim=1)
    wta_depth = torch.gather(dv, 1, wta_index[:, None])[:, 0]
    return masked_ce, wta_depth


def focal_loss_bld(stage_outputs, depth_gt_ms, mask_ms, depth_interval,
                   dlossw=(0.5, 1.0, 2.0), entropy_weight: float = 2.0):
    """Staged entropy loss + BlendedMVS-normalized error metrics.

    Returns (total_loss, last_depth_loss, epe, less1, less3).
    """
    total = 0.0
    depth_loss = 0.0
    stage_keys = sorted(k for k in stage_outputs if k.startswith("stage"))
    for stage_key in stage_keys:
        so = stage_outputs[stage_key]
        mask = (mask_ms[stage_key] > 0.5).to(so["prob_volume"].dtype)
        entro, wta_depth = entropy_loss(so["prob_volume"], depth_gt_ms[stage_key], mask,
                                        so["depth_values"])
        entro = entro * entropy_weight
        depth_loss = masked_smooth_l1(wta_depth, depth_gt_ms[stage_key], mask)
        stage_idx = int(stage_key.replace("stage", "")) - 1
        w = dlossw[stage_idx] if dlossw is not None else 1.0
        total = total + w * entro

    last = f"stage{len(stage_keys)}"
    abs_err = (depth_gt_ms[last] - stage_outputs[last]["depth"]).abs()
    abs_err_scaled = abs_err / (depth_interval * 192.0 / 128.0)
    mask = (mask_ms[last] > 0.5).to(abs_err.dtype)
    cnt = torch.clamp(mask.sum(), min=1.0)
    epe = (abs_err_scaled * mask).sum() / cnt
    less1 = ((abs_err_scaled < 1.0) * mask).sum() / cnt
    less3 = ((abs_err_scaled < 3.0) * mask).sum() / cnt
    return total, depth_loss, epe, less1, less3
