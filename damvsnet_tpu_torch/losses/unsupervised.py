"""Unsupervised / self-supervised losses (RC-MVSNet and KD-MVS family);
counterpart of damvsnet_tpu/losses/unsupervised.py: per-source-view
photometric reconstruction (smooth-L1 and SSIM) of the reference image from
source images warped through the estimated depth, the per-pixel top-k over
views, and an edge-aware first-order depth smoothness term, summed over
stages.

Layouts: images [B, H, W, C] (NHWC) or [B, N, H, W, C]; cams {stage:
[B, N, 2, 4, 4]}; depth maps [B, h, w].
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.resize import resize_bilinear
from .crossview import inverse_warping


def ssim(x, y, c1: float = 0.01 ** 2, c2: float = 0.03 ** 2):
    """SSIM over 3x3 windows (no padding). x, y: [B, H, W, C] in [0, 1].
    Returns the (1 - SSIM)/2 dissimilarity [B, H-2, W-2, C] clipped to
    [0, 1]."""
    def pool(v):
        return F.avg_pool2d(v.permute(0, 3, 1, 2), 3, 1).permute(0, 2, 3, 1)

    mu_x = pool(x)
    mu_y = pool(y)
    sigma_x = pool(x * x) - mu_x ** 2
    sigma_y = pool(y * y) - mu_y ** 2
    sigma_xy = pool(x * y) - mu_x * mu_y
    ssim_n = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    ssim_d = (mu_x ** 2 + mu_y ** 2 + c1) * (sigma_x + sigma_y + c2)
    return torch.clamp((1 - ssim_n / ssim_d) / 2, 0, 1)


def depth_smoothness(depth, img, weight: float = 1.0):
    """Edge-aware first-order smoothness. depth [B, H, W]; img [B, H, W, C]."""
    d = depth[..., None]
    dx = (d[:, :, 1:] - d[:, :, :-1]).abs()
    dy = (d[:, 1:, :] - d[:, :-1, :]).abs()
    ix = (img[:, :, 1:] - img[:, :, :-1]).abs().mean(dim=-1, keepdim=True)
    iy = (img[:, 1:, :] - img[:, :-1, :]).abs().mean(dim=-1, keepdim=True)
    return weight * (torch.mean(dx * torch.exp(-ix)) + torch.mean(dy * torch.exp(-iy)))


def unsup_reconstruction_loss(depth_est, imgs, cams, top_k: int = 3,
                              w_photo: float = 0.8, w_ssim: float = 0.2):
    """Photometric self-supervision for one stage.

    depth_est [B, h, w]; imgs [B, N, H, W, C]; cams [B, N, 2, 4, 4]
    (stage-scaled). Each source image is warped into the reference view
    through the estimated depth and scored against the reference image;
    per pixel the top-k (smallest) over source views count.
    """
    _, hh, ww = depth_est.shape
    num_views = imgs.shape[1]
    ref_img = resize_bilinear(imgs[:, 0], (hh, ww), align_corners=True)
    ref_cam = cams[:, 0]
    per_view = []
    ssim_total = 0.0
    for view in range(1, num_views):
        view_img = resize_bilinear(imgs[:, view], (hh, ww), align_corners=True)
        warped, mask = inverse_warping(view_img, ref_cam, cams[:, view], depth_est)
        diff = (warped - ref_img).abs() * mask
        ad = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5).mean(dim=-1, keepdim=True)
        per_view.append(ad + 1e4 * (1.0 - mask))  # [B,h,w,1]
        ssim_total = ssim_total + torch.mean(ssim(warped * mask, ref_img * mask))
    vol = torch.stack(per_view, dim=-1)  # [B,h,w,1,V-1]
    k = min(top_k, vol.shape[-1])
    top_vals = torch.topk(vol, k, dim=-1, largest=False).values
    top_mask = (top_vals < 1e4).to(vol.dtype)
    photo = torch.mean((top_vals * top_mask).sum(dim=-1))
    return w_photo * photo + w_ssim * ssim_total / max(num_views - 1, 1)


def unsup_loss(stage_outputs, imgs, cams, dlossw=(0.5, 1.0, 2.0),
               w_smooth: float = 0.18, top_k: int = 3):
    """Multi-stage unsupervised loss: reconstruction + edge-aware smoothness.

    Returns (total, last_stage_reconstr)."""
    total = 0.0
    last = 0.0
    for stage_key in sorted(k for k in stage_outputs if k.startswith("stage")):
        depth_est = stage_outputs[stage_key]["depth"]
        _, hh, ww = depth_est.shape
        stage_idx = int(stage_key.replace("stage", "")) - 1
        rec = unsup_reconstruction_loss(depth_est, imgs, cams[stage_key], top_k)
        ref_small = resize_bilinear(imgs[:, 0], (hh, ww), align_corners=True)
        # depth normalized by its mean: the smoothness is scale-invariant
        dmean = depth_est.mean(dim=(1, 2), keepdim=True)
        smooth = depth_smoothness(depth_est / (dmean + 1e-7), ref_small)
        w = dlossw[stage_idx] if dlossw is not None else 1.0
        total = total + w * (rec + w_smooth * smooth)
        last = rec
    return total, last
