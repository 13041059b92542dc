"""Cross-view photometric-consistency (CPC) loss; counterpart of
damvsnet_tpu/losses/crossview.py (reference models/module.py:624-691 and
models/homography.py:7-201).

Each source image is warped into the reference frame twice, with the
estimated depth and with the ground-truth depth; a smooth-L1 between the
two warps is taken per view, and per pixel the two smallest over the
source views are kept (invalid pixels carry a 1e4 penalty and drop out).

The reference's ``_bilinear_sample`` validity mask checks
``(x0>=0) & (x1<=W-1) & (y0>=0) & (y0<=H-1)``: y1 is not checked (y0
appears twice). The quirk is kept, as in the JAX package; it shifts the
mask on the bottom edge.

Across the ranks of a data group the per-view reconstruction loss, a mean
over the whole batch that decides which two views each pixel keeps, is
the global batch's mean (an all-reduce under autograd). Each rank returns
its share of the global loss: its own mean over pixels over the world
size, so that the ranks' values, of equal batches, sum to the global
loss (``losses/supervised.py``).

Camera math runs in true fp32 (``ops.warp.matmul_fp32``). Layouts: imgs
[B, N, H, W, C]; cams {stage: [B, N, 2, 4, 4]} (extrinsics, K-padded);
depth maps [B, h, w].
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.resize import resize_bilinear
from ..parallel.collectives import all_reduce_sum
from ..ops.warp import matmul_fp32


def _bilinear_sample_border(img, px, py):
    """Clamped bilinear sample + the reference's validity mask.

    img [B, H, W, C]; px, py [B, H', W'] absolute pixel coordinates.
    Returns (sampled [B, H', W', C], mask [B, H', W', 1]). The tap weights
    come from the unclamped x0, y0 (floor has zero gradient, so gradient
    reaches px, py through the weights only)."""
    b, h, w, c = img.shape
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    x1 = x0 + 1
    y1 = y0 + 1
    mask = ((x0 >= 0) & (x1 <= w - 1) & (y0 >= 0) & (y0 <= h - 1))
    mask = mask.to(img.dtype)[..., None]

    x0c = x0.clamp(0, w - 1).long()
    x1c = x1.clamp(0, w - 1).long()
    y0c = y0.clamp(0, h - 1).long()
    y1c = y1.clamp(0, h - 1).long()
    flat = img.reshape(b, h * w, c)

    def tap(yi, xi):
        idx = (yi * w + xi).reshape(b, -1, 1).expand(-1, -1, c)
        return torch.gather(flat, 1, idx).reshape(px.shape + (c,))

    wa = ((x1 - px) * (y1 - py))[..., None]
    wb = ((x1 - px) * (1.0 - (y1 - py)))[..., None]
    wc = ((1.0 - (x1 - px)) * (y1 - py))[..., None]
    wd = ((1.0 - (x1 - px)) * (1.0 - (y1 - py)))[..., None]
    out = (wa * tap(y0c, x0c) + wb * tap(y1c, x0c)
           + wc * tap(y0c, x1c) + wd * tap(y1c, x1c))
    return out, mask


def inverse_warping(img, left_cam, right_cam, depth):
    """Warp a source image into the reference frame through a depth map.

    img: [B, h, w, C] (source view, at depth-map resolution);
    left_cam / right_cam: [B, 2, 4, 4] reference / source cameras;
    depth: [B, h, w] reference-frame depth.
    Returns (warped [B, h, w, C], mask [B, h, w, 1]).
    """
    b, h, w, _ = img.shape
    left_cam = left_cam.float()
    right_cam = right_cam.float()
    r_left = left_cam[:, 0, :3, :3]
    r_right = right_cam[:, 0, :3, :3]
    t_left = left_cam[:, 0, :3, 3:4]
    t_right = right_cam[:, 0, :3, 3:4]
    k_left = left_cam[:, 1, :3, :3]

    k_left_inv = torch.linalg.inv(k_left)
    r_rel = matmul_fp32(r_right, r_left.transpose(1, 2))
    t_rel = t_right - matmul_fp32(r_rel, t_left)

    # pixel grid in absolute coordinates (homography.py:66-83)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=img.dtype, device=img.device),
                            torch.arange(w, dtype=img.dtype, device=img.device),
                            indexing="ij")
    grid = torch.stack([xs.reshape(-1), ys.reshape(-1),
                        torch.ones(h * w, dtype=img.dtype, device=img.device)])
    cam_coords = matmul_fp32(k_left_inv, grid[None]) * depth.reshape(b, 1, h * w)
    ones = torch.ones((b, 1, h * w), dtype=img.dtype, device=img.device)
    cam_hom = torch.cat([cam_coords, ones], dim=1)

    # K-homogeneous @ relative transform (homography.py:52-58)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=img.dtype,
                          device=img.device).expand(b, 1, 4)
    transform = torch.cat([torch.cat([r_rel, t_rel], dim=2), bottom], dim=1)
    zeros = torch.zeros((b, 3, 1), dtype=img.dtype, device=img.device)
    k_hom = torch.cat([torch.cat([k_left, zeros], dim=2), bottom], dim=1)
    proj = matmul_fp32(k_hom, transform)

    pcoords = matmul_fp32(proj, cam_hom)  # [B, 4, hw]
    z = pcoords[:, 2:3]
    px = (pcoords[:, 0:1] / (z + 1e-10)).reshape(b, h, w)
    py = (pcoords[:, 1:2] / (z + 1e-10)).reshape(b, h, w)
    return _bilinear_sample_border(img, px, py)


def compute_reconstr_loss(warped, ref, mask):
    """Masked smooth-L1 averaged over every element (module.py:618-620)."""
    diff = warped * mask - ref * mask
    ad = diff.abs()
    return torch.mean(torch.where(ad < 1.0, 0.5 * diff * diff, ad - 0.5))


def cross_view_loss(stage_outputs, imgs, cams, depth_gt_ms, depth_loss_weights,
                    group=None):
    """Total CPC loss over stages (module.py:624-691).

    stage_outputs: {"stageK": {"depth": [B,h,w], ...}};
    imgs [B, N, H, W, C]; cams {"stageK": [B, N, 2, 4, 4]};
    depth_gt_ms {"stageK": [B, h, w]}; group: a data group of ranks with
    equal batches, or None (see the module's docstring).
    """
    num_views = imgs.shape[1]
    world = 1 if group is None else dist.get_world_size(group)
    total = 0.0
    for stage_key in sorted(k for k in stage_outputs if k.startswith("stage")):
        depth_est = stage_outputs[stage_key]["depth"]
        depth_gt = depth_gt_ms[stage_key]
        _, hh, ww = depth_est.shape
        ref_cam = cams[stage_key][:, 0]
        reconstr, masks = [], []
        for view in range(1, num_views):
            view_cam = cams[stage_key][:, view]
            view_img = resize_bilinear(imgs[:, view].float(), (hh, ww),
                                       align_corners=True)
            warped_est, mask_est = inverse_warping(view_img, ref_cam, view_cam, depth_est)
            warped_gt, mask_gt = inverse_warping(view_img, ref_cam, view_cam, depth_gt)
            mask = mask_est * mask_gt
            reconstr.append(compute_reconstr_loss(warped_est, warped_gt, mask))
            masks.append(mask)
        if group is not None:
            reconstr = (all_reduce_sum(torch.stack(reconstr), group) / world).unbind()
        per_view = [r + 1e4 * (1.0 - m) for r, m in zip(reconstr, masks)]  # [B,h,w,1]
        vol = torch.stack(per_view, dim=-1)  # [B,h,w,1,V-1]
        k = min(2, vol.shape[-1])
        top_vals = torch.topk(vol, k, dim=-1, largest=False).values
        top_vals = top_vals * (top_vals < 1e4).to(vol.dtype)
        stage_loss = torch.mean(torch.sum(top_vals, dim=-1)) / world
        stage_idx = int(stage_key.replace("stage", "")) - 1
        total = total + stage_loss * depth_loss_weights[stage_idx]
    return total
