"""Plane-sweep homography geometry and zero-padded bilinear sampling
(counterpart of damvsnet_tpu/ops/warp.py).

Numerics follow the reference ``homo_warping``:

  * proj = src_proj @ inv(ref_proj); rot = proj[:3,:3], trans = proj[:3,3]
  * for each depth hypothesis d(b, k[, y, x]):
        p = rot @ (x, y, 1)^T * d + trans;  (u, v) = (p.x/p.z, p.y/p.z)
  * normalized grid  gx = u / ((W-1)/2) - 1,  gy = v / ((H-1)/2) - 1
  * sampled like ``F.grid_sample(padding_mode='zeros')`` whose default
    ``align_corners=False`` un-normalizes as px = ((gx+1) * W - 1) / 2.

The (W-1)/2 normalization against an align_corners=False un-normalization
is the reference's quirk and is kept: it is px = u * W/(W-1) - 0.5, the
affine form (sx, ox) the kernels evaluate. ``align_corners=True`` (read
only by the variance cost volume, as in the JAX package) un-normalizes as
px = (gx+1) * (W-1) / 2, which is px = u.

Camera geometry runs in true fp32: the small products are written as
elementwise multiply-adds, which never take the TF32 tensor-core path
whatever ``torch.backends`` allow.

Layout: features NHWC [B, H, W, C]; coordinates [B, D, H, W].
"""
from __future__ import annotations

import torch


def matmul_fp32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., m, k] @ b [..., k, n] as an elementwise fp32 sum."""
    return (a.float()[..., :, :, None] * b.float()[..., None, :, :]).sum(-2)


def relative_projection(src_proj: torch.Tensor, ref_proj: torch.Tensor) -> torch.Tensor:
    """[B, 4, 4] src_proj @ inv(ref_proj) in fp32. ``inv_ex`` skips the
    singularity check, which would synchronise with the device."""
    return matmul_fp32(src_proj, torch.linalg.inv_ex(ref_proj.float()).inverse)


def geoms_from_projs(src_projs, ref_proj: torch.Tensor) -> torch.Tensor:
    """[V, B, 12] fused-homography rows (rot row-major, then trans), fp32,
    of V source projections [B, 4, 4] — the per-view geometry the
    plane-sweep kernels read — with one inverse of the reference projection
    and one fp32 product over the stacked views."""
    inv = torch.linalg.inv_ex(ref_proj.float()).inverse
    proj = matmul_fp32(torch.stack(list(src_projs)), inv)  # [V, B, 4, 4]
    return torch.cat([proj[..., :3, :3].flatten(-2), proj[..., :3, 3]], dim=-1)


def geom_from_projs(src_proj: torch.Tensor, ref_proj: torch.Tensor) -> torch.Tensor:
    """[B, 12] ``geoms_from_projs`` of one source view."""
    return geoms_from_projs([src_proj], ref_proj)[0]


def pixel_affine(size: int, align_corners: bool = False):
    """(s, o) with px = u * s + o: the normalize/un-normalize round trip."""
    if align_corners:
        return 1.0, 0.0
    return size / (size - 1.0), -0.5


def _unnormalize(g: torch.Tensor, size: int, align_corners: bool) -> torch.Tensor:
    if align_corners:
        return (g + 1.0) * (size - 1) / 2.0
    return ((g + 1.0) * size - 1.0) / 2.0


def plane_sweep_grid(src_proj: torch.Tensor, ref_proj: torch.Tensor,
                     depth_values: torch.Tensor, height: int, width: int,
                     align_corners: bool = False):
    """Source-image pixel coordinates (px, py), each [B, D, H, W].

    src_proj, ref_proj: [B, 4, 4] fused K·[R|t]; depth_values [B, D] or
    [B, D, H, W]."""
    b, d = depth_values.shape[:2]
    proj = relative_projection(src_proj, ref_proj)
    rot = proj[:, :3, :3]
    trans = proj[:, :3, 3]
    dev = depth_values.device
    y, x = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=dev),
                          torch.arange(width, dtype=torch.float32, device=dev),
                          indexing="ij")
    x = x.reshape(1, 1, -1)
    y = y.reshape(1, 1, -1)
    rot_xyz = rot[:, :, 0:1] * x + rot[:, :, 1:2] * y + rot[:, :, 2:3]  # [B,3,HW]
    depth = depth_values.float().reshape(b, 1, d, -1)  # [B,1,D,1] or [B,1,D,HW]
    proj_xyz = rot_xyz[:, :, None, :] * depth + trans[:, :, None, None]
    z = proj_xyz[:, 2]
    u = proj_xyz[:, 0] / z
    v = proj_xyz[:, 1] / z
    gx = u / ((width - 1) / 2.0) - 1.0
    gy = v / ((height - 1) / 2.0) - 1.0
    px = _unnormalize(gx, width, align_corners).reshape(b, d, height, width)
    py = _unnormalize(gy, height, align_corners).reshape(b, d, height, width)
    return px, py


def bilinear_sample_zeros(img: torch.Tensor, px: torch.Tensor,
                          py: torch.Tensor) -> torch.Tensor:
    """Bilinear sample with zero padding (grid_sample 'zeros' semantics).

    img: [B, H, W, C]; px, py: [B, ...] pixel coordinates. Returns
    [B, ..., C] in fp32. Out-of-bounds taps contribute zero; a non-finite
    coordinate samples to zero. Bounds are tested in float before any cast
    to int, so a huge coordinate cannot wrap into a valid index.
    """
    b, h, w, c = img.shape
    out_shape = px.shape[1:]
    px = px.reshape(b, -1).float()
    py = py.reshape(b, -1).float()
    fin = torch.isfinite(px) & torch.isfinite(py)
    # any coordinate outside [-1, W] has both taps outside the image, so
    # clamping to [-2, W+1] changes no in-image tap
    px = torch.where(fin, px.clamp(-2.0, w + 1.0), torch.full_like(px, -2.0))
    py = torch.where(fin, py.clamp(-2.0, h + 1.0), torch.full_like(py, -2.0))
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    wx = (px - x0)[..., None]
    wy = (py - y0)[..., None]
    img_flat = img.reshape(b, h * w, c).float()

    def tap(xf, yf):
        valid = (xf >= 0) & (xf <= w - 1) & (yf >= 0) & (yf <= h - 1)
        idx = (yf.clamp(0, h - 1) * w + xf.clamp(0, w - 1)).long()
        # torch.gather, whose backward is a scatter-add (atomics on the
        # card): advanced indexing's backward sorts the indices and took
        # half the non-fused training step's device time there, and
        # index_select with index_add_ took 5.7x gather's (PERF.md)
        return torch.gather(img_flat, 1, idx[..., None].expand(-1, -1, c)) * valid[..., None]

    out = (tap(x0, y0) * (1 - wx) * (1 - wy) + tap(x0 + 1, y0) * wx * (1 - wy)
           + tap(x0, y0 + 1) * (1 - wx) * wy + tap(x0 + 1, y0 + 1) * wx * wy)
    return out.reshape((b,) + tuple(out_shape) + (c,))


def plane_sweep_warp(src_fea: torch.Tensor, src_proj: torch.Tensor,
                     ref_proj: torch.Tensor, depth_values: torch.Tensor,
                     align_corners: bool = False) -> torch.Tensor:
    """Warp source features over depth hypotheses into the reference
    frustum: [B, H, W, C] -> [B, D, H, W, C] fp32. The plain version of
    the plane-sweep sampler kernel (ops/kernels/sweep_sampler.py), and the
    non-fused training step's sampler. Gradient reaches the source
    features only: the sampling coordinates are detached, as the
    reference's grid is built under no_grad (module.py:297-300), so the
    depth hypotheses and the projections get none."""
    _, h, w, _ = src_fea.shape
    px, py = plane_sweep_grid(src_proj, ref_proj, depth_values, h, w, align_corners)
    return bilinear_sample_zeros(src_fea, px.detach(), py.detach())
