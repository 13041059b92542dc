"""Plain fp32 operations of the cascade: depth sampling, plane-sweep
warping, cost volumes and the probability-volume statistics.

Written from the reference DA-MVSNet (models/module.py, homography.py)
in plain PyTorch, with its quirks kept: the warp normalizes by (W-1)/2 and
un-normalizes as ``grid_sample(align_corners=False)`` does, so a source
pixel is px = u * W / (W - 1) - 0.5; taps outside the image read zero.
Layouts: features [B, C, H, W], volumes [B, C, D, H, W], depth
hypotheses [B, D, H, W].
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

EPS = 1e-12


def uniform_samples(depth_values, ndepth, h, w):
    """[B, D0] sweep -> [B, D, h, w], D uniform hypotheses from its first
    to its last entry."""
    dmin, dmax = depth_values[:, 0], depth_values[:, -1]
    i = torch.arange(ndepth, dtype=torch.float32, device=depth_values.device)
    d = dmin[:, None] + i[None] * ((dmax - dmin) / (ndepth - 1))[:, None]
    return d[:, :, None, None].expand(-1, -1, h, w)


def adia_samples(depth, sigma, ndepth):
    """Uncertainty-aware samples around the previous depth: depth, sigma
    [B, 1, H, W] -> [B, D, H, W]."""
    low = -torch.minimum(depth, sigma)
    step = (sigma - low) / (ndepth - 1.0)
    i = torch.arange(ndepth, dtype=torch.float32, device=depth.device).view(1, -1, 1, 1)
    ramp = low + step * i
    offset = torch.softmax(3.0 * ramp / (sigma + EPS), dim=1)
    return depth + ramp + EPS + offset * step


def homography_coords(src_proj, ref_proj, depth, h, w):
    """Source pixel coordinates (px, py) [B, D, h, w] of every reference
    pixel at every hypothesis; projections fused [B, 4, 4]."""
    b, d = depth.shape[:2]
    proj = src_proj.double() @ torch.linalg.inv(ref_proj.double())
    proj = proj.float()
    rot, trans = proj[:, :3, :3], proj[:, :3, 3]
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=depth.device),
                            torch.arange(w, dtype=torch.float32, device=depth.device),
                            indexing="ij")
    xyz = torch.stack([xs.reshape(-1), ys.reshape(-1), torch.ones_like(xs).reshape(-1)])
    rot_xyz = torch.einsum("bij,jn->bin", rot, xyz)  # [B, 3, hw]
    p = rot_xyz[:, :, None, :] * depth.reshape(b, 1, d, h * w) + trans[:, :, None, None]
    u, v = p[:, 0] / p[:, 2], p[:, 1] / p[:, 2]
    px = (u / ((w - 1) / 2.0) - 1.0 + 1.0) * w / 2.0 - 0.5
    py = (v / ((h - 1) / 2.0) - 1.0 + 1.0) * h / 2.0 - 0.5
    return px.reshape(b, d, h, w), py.reshape(b, d, h, w)


def sample_zeros(fea, px, py):
    """Bilinear sample of fea [B, C, H, W] at (px, py) [B, D, h, w] with
    zero padding -> [B, C, D, h, w]; the coordinates carry no gradient."""
    b, c, h, w = fea.shape
    # a non-finite or far-off coordinate reads zero, as a tap outside does
    ok = torch.isfinite(px) & torch.isfinite(py)
    px = torch.where(ok, px.detach().clamp(-2.0, w + 1.0), torch.full_like(px, -2.0))
    py = torch.where(ok, py.detach().clamp(-2.0, h + 1.0), torch.full_like(py, -2.0))
    grid = torch.stack([(2 * px + 1) / w - 1, (2 * py + 1) / h - 1], dim=-1)
    d = px.shape[1]
    out = F.grid_sample(fea, grid.reshape(b, d * px.shape[2], px.shape[3], 2),
                        mode="bilinear", padding_mode="zeros", align_corners=False)
    return out.reshape(b, c, d, px.shape[2], px.shape[3])


def fuse_proj(proj):
    """[B, 2, 4, 4] (extrinsics, K) -> [B, 4, 4] with rows 0-2 K @ E[:3]."""
    ext, k = proj[:, 0].double(), proj[:, 1, :3, :3].double()
    return torch.cat([k @ ext[:, :3], ext[:, 3:]], dim=1).float()


def prob_stats(cost, samples):
    """cost [B, D, H, W] (pre-softmax), samples [B, D, H, W] -> depth,
    photometric confidence, 3-sigma band, prob volume."""
    prob = torch.softmax(cost, dim=1)
    depth = (prob * samples).sum(1)
    p = prob.detach()
    d = p.shape[1]
    iota = torch.arange(d, dtype=torch.float32, device=p.device).view(1, -1, 1, 1)
    idx = (p * iota).sum(1).to(torch.int64).clamp(0, d - 1)[:, None].float()
    window = ((iota >= idx - 1) & (iota <= idx + 2)).float()
    conf = (p * window).sum(1)
    sigma = 3.0 * torch.sqrt(((samples - depth[:, None]) ** 2 * prob).sum(1))
    return {"depth": depth, "photometric_confidence": conf, "variance": sigma,
            "prob_volume": prob}
