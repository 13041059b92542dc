"""Supervised staged depth loss (+ CPC composition); counterpart of
damvsnet_tpu/losses/supervised.py.

Per-stage masked smooth-L1 (mask > 0.5) weighted by dlossw (0.5, 1, 2)
plus 12x the cross-view photometric-consistency loss (reference
``cas_mvsnet_loss``, models/module.py:695-719).

Across the ranks of a data group (``group``), the loss is the JAX
package's on the global batch, whose masked means divide by the global
mask count. Each rank returns its share of that loss (its masked sum over
the global count): the ranks' values sum to the global loss. A caller
that lets DDP average the ranks' gradients scales the shares by the
world size first (``train/loop.py``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .crossview import cross_view_loss

CPC_WEIGHT = 12.0


def smooth_l1(pred, target):
    """Elementwise smooth-L1 (beta = 1, torch default)."""
    diff = pred - target
    ad = diff.abs()
    return torch.where(ad < 1.0, 0.5 * diff * diff, ad - 0.5)


def masked_smooth_l1(pred, target, mask, count=None):
    """Mean smooth-L1 over mask-selected elements (torch boolean indexing
    + reduction='mean'), as a masked sum so no shape depends on the data.
    ``count``: the divisor in place of the mask's own count."""
    m = mask.to(pred.dtype)
    total = torch.sum(smooth_l1(pred, target) * m)
    return total / torch.clamp(m.sum() if count is None else count, min=1.0)


def cas_mvsnet_loss(stage_outputs, imgs, cams, depth_gt_ms, mask_ms,
                    dlossw=(0.5, 1.0, 2.0), cpc_weight: float = CPC_WEIGHT,
                    use_cpc: bool = True, group=None):
    """Returns (total_loss, last_stage_depth_loss, cpc_loss).

    stage_outputs: {"stageK": {"depth": ...}}; imgs [B,N,H,W,C];
    cams {"stageK": [B,N,2,4,4]}; depth_gt_ms / mask_ms {"stageK": [B,h,w]}.
    group: a data group whose ranks hold equal parts of the global batch,
    or None; with a group each returned loss is this rank's share of the
    global batch's (see the module's docstring).
    """
    stage_keys = sorted(k for k in stage_outputs if k.startswith("stage"))
    masks = {k: mask_ms[k] > 0.5 for k in stage_keys}
    counts = dict.fromkeys(stage_keys)
    if group is not None:
        # the global mask counts over the world, one collective, no gradient
        local = torch.stack([masks[k].sum() for k in stage_keys]).float()
        dist.all_reduce(local, group=group)
        counts = dict(zip(stage_keys, local))
    total_depth_loss = 0.0
    depth_loss = None
    for stage_key in stage_keys:
        depth_est = stage_outputs[stage_key]["depth"]
        depth_loss = masked_smooth_l1(depth_est, depth_gt_ms[stage_key], masks[stage_key],
                                      counts[stage_key])
        stage_idx = int(stage_key.replace("stage", "")) - 1
        total_depth_loss = total_depth_loss + dlossw[stage_idx] * depth_loss

    if use_cpc:
        cpc = cross_view_loss(stage_outputs, imgs, cams, depth_gt_ms, dlossw, group)
    else:
        cpc = torch.zeros((), device=imgs.device)
    return total_depth_loss + cpc * cpc_weight, depth_loss, cpc
