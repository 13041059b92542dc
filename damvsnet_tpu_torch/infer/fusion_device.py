"""Device-batched geometric-consistency fusion; counterpart of
damvsnet_tpu/infer/fusion_tpu.py.

The per-(reference, source) reprojection round trip — backproject,
transform, bilinearly resample the source depth (cv2.remap semantics: zero
outside the image), reproject — is dense torch on one device, batched over
the V source views of a reference ([V, H, W]) the way the JAX module vmaps
``_consistency_one_src``. Only the compaction into a vertex list (variable
length) runs on the host, as in JAX.

Semantics: the dynamic thresholds and vote of the reference's
filter/dypcd.py:98-159, or, with ``num_consistent``, the fixed
fusibile-style vote. Every camera product and inverse is true fp32, as
the JAX module's ``Precision.HIGHEST``: a pixel shift would flip threshold
votes. The small matrices are computed once per reference on the host
(``ops.warp.matmul_fp32``, elementwise, never TF32), and the per-pixel
products are fp32 sums evaluated left to right one elementwise operation
at a time, so the card votes as the CPU does, bit for bit where both
round correctly. A zero reference depth divides by zero, as in JAX, and
fails every threshold.

Runs on CUDA unless the caller names another device.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..core import imageio
from ..core.pairs import read_pair_file
from ..core.pfm import read_pfm
from ..core.ply import write_ply
from ..ops.warp import bilinear_sample_zeros, matmul_fp32
from ..utils.device import resolve_device
from .fusion_dypcd import read_camera_parameters
from .tank_config import TANK_CFG


def _rows(m, x, y, z, t=None):
    """The rows of m [..., 3, 3] applied to (x, y, z), each [..., P] or a
    scalar, plus t [..., 3]: three fp32 sums evaluated left to right, one
    elementwise operation at a time, so every device rounds alike."""
    out = []
    for r in range(3):
        v = m[..., r, 0:1] * x + m[..., r, 1:2] * y + m[..., r, 2:3] * z
        out.append(v if t is None else v + t[..., r:r + 1])
    return out


def camera_terms(intr_ref, ext_ref, intr_src, ext_src):
    """The small camera matrices of one reference against V sources, fp32 on
    the host: K_ref^-1, K_src^-1 [V, 3, 3], src <- ref and ref <- src
    [V, 4, 4]. Computed on the CPU whatever device votes, so the card and
    the CPU start from the same bits."""
    cpu = [torch.as_tensor(np.ascontiguousarray(a, np.float32))
           for a in (intr_ref, ext_ref, intr_src, ext_src)]
    intr_ref, ext_ref, intr_src, ext_src = cpu
    inv = torch.linalg.inv
    return (inv(intr_ref), inv(intr_src), matmul_fp32(ext_src, inv(ext_ref)),
            matmul_fp32(ext_ref, inv(ext_src)))


def reprojection_errors(depth_ref, intr_ref, depth_src, intr_src, terms):
    """The round trip of a reference against V sources, fp32 tensors on one
    device: depth_ref [H, W], intr_ref [3, 3], depth_src [V, H, W],
    intr_src [V, 3, 3], ``terms`` = ``camera_terms`` on that device.
    Returns (dist, rel_diff, depth_reproj), each [V, H, W]: how far the
    reference pixel lands from itself, in pixels; |reprojected - reference
    depth| / reference depth; the reprojected depth."""
    inv_k_ref, inv_k_src, rel, rel_back = terms
    v, h, w = depth_src.shape
    dev = depth_ref.device
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    x, y = xs.reshape(-1), ys.reshape(-1)

    # reference pixel -> world -> source pixel
    d = depth_ref.reshape(-1)
    cam = [c * d for c in _rows(inv_k_ref, x, y, 1.0)]
    src = _rows(rel[:, :3, :3], *cam, t=rel[:, :3, 3])  # [V, HW] each
    k = _rows(intr_src, *src)
    x_src, y_src = k[0] / k[2], k[1] / k[2]

    sampled = bilinear_sample_zeros(depth_src[..., None], x_src, y_src)[..., 0]

    # source pixel at the sampled source depth -> world -> reference pixel
    cam2 = [c * sampled for c in _rows(inv_k_src, x_src, y_src, 1.0)]
    back = _rows(rel_back[:, :3, :3], *cam2, t=rel_back[:, :3, 3])
    depth_reproj = back[2].reshape(v, h, w)
    k2 = _rows(intr_ref, *back)
    z = torch.where(k2[2] == 0, k2[2] + 1e-5, k2[2])
    x_re, y_re = (k2[0] / z).reshape(v, h, w), (k2[1] / z).reshape(v, h, w)

    dist = torch.sqrt((x_re - xs) ** 2 + (y_re - ys) ** 2)
    rel_diff = (depth_reproj - depth_ref).abs() / depth_ref
    return dist, rel_diff, depth_reproj


def consistency_masks(depth_ref, intr_ref, depth_src, intr_src, terms,
                      dist_base, rel_diff_base, dyn_lo: int = 2, dyn_hi: int = 11):
    """The votes of a reference against V sources (``reprojection_errors``'
    arguments). Returns (masks [V, T, H, W] for the thresholds
    dyn_lo..dyn_hi-1, final mask [V, H, W] (the last threshold), reprojected
    depth [V, H, W], zero where the final mask fails)."""
    dist, rel_diff, depth_reproj = reprojection_errors(depth_ref, intr_ref, depth_src,
                                                       intr_src, terms)
    dev = depth_ref.device
    thresholds = torch.arange(dyn_lo, dyn_hi, dtype=torch.float32, device=dev)[:, None, None]
    masks = ((dist[:, None] < thresholds * dist_base)
             & (rel_diff[:, None] < thresholds * rel_diff_base))
    final = masks[:, -1]
    return masks, final, torch.where(final, depth_reproj, 0.0)


def fuse_reference_view(depth_ref, intr_ref, ext_ref, src_depths, src_intrs, src_exts,
                        dist_base=0.25, rel_diff_base=1.0 / 1300, num_consistent=None,
                        device=None):
    """Vote-fuse one reference view against V sources on ``device`` (CUDA
    unless named). Inputs are numpy: depth [H, W], K [3, 3], E [4, 4], and
    their V-stacked source counterparts. By default the dynamic dypcd vote
    (filter/dypcd.py:240-252); with ``num_consistent`` the fixed vote
    geo_mask_sum >= n (gipuma.py:170-189). Returns (geo_mask [H, W] bool,
    fused depth [H, W] fp32) as numpy."""
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)

    terms = [m.to(dev) for m in camera_terms(intr_ref, ext_ref, src_intrs, src_exts)]
    depth_ref = t(depth_ref)
    masks, final, reproj = consistency_masks(depth_ref, t(intr_ref), t(src_depths),
                                             t(src_intrs), terms, dist_base, rel_diff_base)
    geo_mask_sum = final.sum(0, dtype=torch.int32)
    total = reproj[0]
    for r in reproj[1:]:  # left to right, as _rows sums
        total = total + r
    depth_avg = (total + depth_ref) / (geo_mask_sum + 1)
    if num_consistent is not None:
        geo_mask = geo_mask_sum >= num_consistent
    else:
        nviews = src_depths.shape[0] + 1
        geo_mask = geo_mask_sum >= nviews
        mask_sums = masks.sum(0, dtype=torch.int32)  # [T, H, W]
        for i in range(2, nviews):
            geo_mask = geo_mask | (mask_sums[i - 2] >= i)
    return geo_mask.cpu().numpy(), depth_avg.cpu().numpy()


def consistency_filter(datapath, outdir, testlist, conf=(0.1, 0.15, 0.9),
                       dist_base=0.25, rel_diff_base=1.0 / 1300,
                       num_consistent=None, log_fn=print, device=None):
    """Fuse every scene of ``testlist`` into outdir/{scene}.ply, each
    reference view's vote on ``device`` (CUDA unless named), the vertex
    lists on the host. With num_consistent set, the fixed acceptance
    geo_mask_sum >= num_consistent replaces the dynamic vote."""
    for scene in testlist:
        scene_conf = conf
        if scene in TANK_CFG["scenes"]:
            scene_conf = TANK_CFG[scene]["conf"]
        pair_data = read_pair_file(os.path.join(datapath, scene, "pair.txt"))
        scan_folder = os.path.join(outdir, scene)
        vertexs, vertex_colors = [], []

        cams, depths = {}, {}
        for v in sorted({v for r, s in pair_data for v in [r] + s}):
            cams[v] = read_camera_parameters(os.path.join(scan_folder, f"cams/{v:0>8}_cam.txt"))
            depths[v] = read_pfm(os.path.join(scan_folder, f"depth_est/{v:0>8}.pfm"))[0]

        for ref_view, src_views in pair_data:
            ref_intr, ref_ext = cams[ref_view]
            conf_maps = [read_pfm(os.path.join(scan_folder, f"confidence/{ref_view:0>8}{sfx}.pfm"))[0]
                         for sfx in ("", "_stage2", "_stage1")]
            photo_mask = ((conf_maps[0] > scene_conf[2]) & (conf_maps[1] > scene_conf[1])
                          & (conf_maps[2] > scene_conf[0]))
            geo_mask, depth_avg = fuse_reference_view(
                depths[ref_view], ref_intr, ref_ext,
                np.stack([depths[v] for v in src_views]),
                np.stack([cams[v][0] for v in src_views]),
                np.stack([cams[v][1] for v in src_views]),
                dist_base, rel_diff_base, num_consistent=num_consistent, device=device)

            final_mask = photo_mask & geo_mask
            h, w = depth_avg.shape
            x, y = np.meshgrid(np.arange(w), np.arange(h))
            x, y, depth = x[final_mask], y[final_mask], depth_avg[final_mask]
            ref_img = imageio.read_rgb(
                os.path.join(scan_folder, f"images/{ref_view:0>8}.jpg")).astype(np.float32) / 255.0
            color = ref_img[final_mask]
            xyz_ref = np.matmul(np.linalg.inv(ref_intr),
                                np.vstack((x, y, np.ones_like(x))) * depth)
            xyz_world = np.matmul(np.linalg.inv(ref_ext),
                                  np.vstack((xyz_ref, np.ones_like(x))))[:3]
            vertexs.append(xyz_world.T)
            vertex_colors.append((color * 255).astype(np.uint8))

        vertexs = np.concatenate(vertexs, axis=0)
        vertex_colors = np.concatenate(vertex_colors, axis=0)
        ply_path = os.path.join(outdir, f"{scene}.ply")
        write_ply(ply_path, vertexs, vertex_colors)
        log_fn(f"saved {len(vertexs)} points to {ply_path}")
