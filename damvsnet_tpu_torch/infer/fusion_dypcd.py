"""Dynamic geometric-consistency point-cloud fusion ("dypcd"); a copy of
damvsnet_tpu/infer/fusion_dypcd.py (host numpy, cv2.remap).

The primary DTU/TnT fusion path. Numerics parity with the reference's
filter/dypcd.py:98-326:

  * reproject_with_depth: ref depth -> source view -> bilinear-resample the
    source depth (cv2.remap semantics) -> back to ref; yields reprojection
    pixel distance and relative depth difference.
  * dynamic thresholds: masks for i in [2, 11): dist < i * dist_base and
    rel_diff < i * rel_diff_base; a pixel passes if any
    geo_mask_sums[i] >= i (vote), or >= len(src_views)+1 matches.
  * photo mask: 3-stage confidence AND (conf_s > conf[s]).
  * fused depth = mean of accepted reprojected depths (incl. ref).
  * masked pixels backproject to a colored world-frame PLY.

Backend order: the fused C++ consistency pass (native/fusion.cpp) is the
primary host path (used automatically when the toolchain built it); the
device-batched fusion lives in fusion_device.py; the numpy functions in
this file are the numerics-parity oracle both are tested against
(tests/test_torch_fusion.py) and the portable fallback. Images are read
through core.imageio; the mask PNGs are written with PIL.
"""
from __future__ import annotations

import os

import numpy as np

from ..core import imageio
from ..core.pairs import read_pair_file
from ..core.pfm import read_pfm
from ..core.ply import write_ply
from .tank_config import TANK_CFG


def read_camera_parameters(filename):
    """(parity: filter/dypcd.py:70-80 — full-resolution K, no /4)."""
    with open(filename) as f:
        lines = [line.rstrip() for line in f.readlines()]
    extrinsics = np.fromstring(" ".join(lines[1:5]), dtype=np.float32,
                               sep=" ").reshape(4, 4)
    intrinsics = np.fromstring(" ".join(lines[7:10]), dtype=np.float32,
                               sep=" ").reshape(3, 3)
    return intrinsics, extrinsics


def reproject_with_depth(depth_ref, intr_ref, ext_ref, depth_src, intr_src,
                         ext_src):
    """Round-trip reprojection: ref depth -> src view -> back to ref.

    PROVENANCE / ROLE: this is the numerics-parity *oracle* for the two
    primary fusion backends — the fused C++ pass (native/fusion.cpp,
    checked against this in tests/test_torch_fusion.py) and the
    device-batched fusion (fusion_device.py). It reproduces the classic open-source
    MVSNet consistency round trip (semantics of filter/dypcd.py:98-136)
    but is organized around composed camera-to-camera maps applied to
    (H, W, 3) pixel-ray arrays: one 4x4 `src<-ref` / `ref<-src` transform
    per direction, row-vector einsum form, float64 throughout the
    geometry (the promotion the reference gets implicitly), f32 only at
    the cv2.remap boundary and the returned maps.
    """
    import cv2
    h, w = depth_ref.shape
    # homogeneous pixel rays of the ref view, (H, W, 3)
    yy, xx = np.mgrid[0:h, 0:w]
    rays_ref = np.stack([xx, yy, np.ones_like(xx)], axis=-1).astype(np.float64)

    # composed camera-to-camera rigid maps (4x4), one per direction
    ext_ref64 = ext_ref.astype(np.float64)
    ext_src64 = ext_src.astype(np.float64)
    src_from_ref = ext_src64 @ np.linalg.inv(ext_ref64)
    ref_from_src = ext_ref64 @ np.linalg.inv(ext_src64)
    kinv_ref = np.linalg.inv(intr_ref.astype(np.float64))
    kinv_src = np.linalg.inv(intr_src.astype(np.float64))

    def transform(points, rigid):  # (H,W,3) cam points through a 4x4
        return points @ rigid[:3, :3].T + rigid[:3, 3]

    # leg 1: ref pixels at estimated depth -> src camera -> src pixels
    cam_ref = (rays_ref @ kinv_ref.T) * depth_ref[..., None]
    pix_src = transform(cam_ref, src_from_ref) @ intr_src.astype(np.float64).T
    xy_src = pix_src[..., :2] / pix_src[..., 2:3]
    x_src = xy_src[..., 0].astype(np.float32)
    y_src = xy_src[..., 1].astype(np.float32)
    sampled_depth_src = cv2.remap(depth_src, x_src, y_src,
                                  interpolation=cv2.INTER_LINEAR)

    # leg 2: those src pixels at the *source's* estimated depth -> ref
    rays_src = np.concatenate([xy_src, np.ones((h, w, 1))], axis=-1)
    cam_src = (rays_src @ kinv_src.T) * sampled_depth_src[..., None].astype(np.float64)
    cam_reproj = transform(cam_src, ref_from_src)
    depth_reproj = cam_reproj[..., 2].astype(np.float32)
    pix_reproj = cam_reproj @ intr_ref.astype(np.float64).T
    z = pix_reproj[..., 2:3]
    z[z == 0] += 0.00001  # the reference's guard against division by zero
    xy_reproj = pix_reproj[..., :2] / z
    x_reproj = xy_reproj[..., 0].astype(np.float32)
    y_reproj = xy_reproj[..., 1].astype(np.float32)
    return depth_reproj, x_reproj, y_reproj, x_src, y_src


def check_geometric_consistency(depth_ref, intr_ref, ext_ref, depth_src,
                                intr_src, ext_src, dist_base=0.25,
                                rel_diff_base=1.0 / 1300):
    """Dynamic-threshold consistency masks (semantics: dypcd.py:139-159).

    All nine thresholds i in [2, 11) are evaluated at once on a stacked
    [9, H, W] comparison; mask i passes where reprojection error
    < i*dist_base px AND relative depth difference < i*rel_diff_base.
    Parity oracle for the native/TPU backends (see reproject_with_depth).
    """
    h, w = depth_ref.shape
    depth_reproj, x2d_reproj, y2d_reproj, x2d_src, y2d_src = \
        reproject_with_depth(depth_ref, intr_ref, ext_ref, depth_src,
                             intr_src, ext_src)
    yy, xx = np.mgrid[0:h, 0:w]
    dist = np.hypot(x2d_reproj - xx, y2d_reproj - yy)
    rel_diff = np.abs(depth_reproj - depth_ref) / depth_ref

    thr = np.arange(2, 11, dtype=np.float64)[:, None, None]
    mask_stack = (dist[None] < thr * dist_base) \
        & (rel_diff[None] < thr * rel_diff_base)
    masks = list(mask_stack)
    geo_mask = masks[-1]
    depth_reproj = np.where(geo_mask, depth_reproj, 0.0).astype(np.float32)
    return masks, geo_mask, depth_reproj, x2d_src, y2d_src


def filter_depth_dypcd(pair_folder, scan_folder, out_folder, plyfilename,
                       conf=(0.1, 0.15, 0.9), dist_base=0.25,
                       rel_diff_base=1.0 / 1300, save_masks=True,
                       use_native=True, log_fn=print):
    """Fuse one scene's depth maps into a PLY (parity: dypcd.py:179-326).

    use_native: run the consistency round trip through the C++ kernel
    (native/fusion.cpp) when the toolchain is available — one fused pass
    instead of the dozen numpy temporaries; numerics identical
    (tests/test_native.py)."""
    native_check = None
    if use_native:
        from ..native_ext import dypcd_consistency_native, get_lib
        if get_lib() is not None:
            native_check = dypcd_consistency_native

    pair_data = read_pair_file(os.path.join(pair_folder, "pair.txt"))
    vertexs = []
    vertex_colors = []
    for ref_view, src_views in pair_data:
        ref_intr, ref_ext = read_camera_parameters(
            os.path.join(scan_folder, f"cams/{ref_view:0>8}_cam.txt"))
        ref_img = imageio.read_rgb(
            os.path.join(scan_folder, f"images/{ref_view:0>8}.jpg")).astype(np.float32) / 255.0
        ref_depth_est = read_pfm(
            os.path.join(out_folder, f"depth_est/{ref_view:0>8}.pfm"))[0]
        confidence = read_pfm(
            os.path.join(out_folder, f"confidence/{ref_view:0>8}.pfm"))[0]
        confidence2 = read_pfm(
            os.path.join(out_folder, f"confidence/{ref_view:0>8}_stage2.pfm"))[0]
        confidence1 = read_pfm(
            os.path.join(out_folder, f"confidence/{ref_view:0>8}_stage1.pfm"))[0]
        photo_mask = np.logical_and(
            np.logical_and(confidence > conf[2], confidence2 > conf[1]),
            confidence1 > conf[0])

        all_srcview_depth_ests = []
        geo_mask_sum = 0
        dy_range = len(src_views) + 1
        geo_mask_sums = [0] * (dy_range - 2)
        for src_view in src_views:
            src_intr, src_ext = read_camera_parameters(
                os.path.join(scan_folder, f"cams/{src_view:0>8}_cam.txt"))
            src_depth_est = read_pfm(
                os.path.join(out_folder, f"depth_est/{src_view:0>8}.pfm"))[0]
            if native_check is not None:
                masks, geo_mask, depth_reproj = native_check(
                    ref_depth_est, ref_intr, ref_ext, src_depth_est,
                    src_intr, src_ext, dist_base, rel_diff_base)
            else:
                masks, geo_mask, depth_reproj, _, _ = check_geometric_consistency(
                    ref_depth_est, ref_intr, ref_ext, src_depth_est, src_intr,
                    src_ext, dist_base, rel_diff_base)
            geo_mask_sum += geo_mask.astype(np.int32)
            for i in range(2, dy_range):
                geo_mask_sums[i - 2] += masks[i - 2].astype(np.int32)
            all_srcview_depth_ests.append(depth_reproj)

        depth_est_averaged = (sum(all_srcview_depth_ests) + ref_depth_est) \
            / (geo_mask_sum + 1)
        geo_mask = geo_mask_sum >= dy_range
        for i in range(2, dy_range):
            geo_mask = np.logical_or(geo_mask, geo_mask_sums[i - 2] >= i)
        final_mask = np.logical_and(photo_mask, geo_mask)

        if save_masks:
            from PIL import Image
            os.makedirs(os.path.join(out_folder, "mask"), exist_ok=True)
            for name, m in (("photo", photo_mask), ("geo", geo_mask),
                            ("final", final_mask)):
                Image.fromarray((m.astype(np.uint8) * 255)).save(
                    os.path.join(out_folder, f"mask/{ref_view:0>8}_{name}.png"))

        height, width = depth_est_averaged.shape
        x, y = np.meshgrid(np.arange(width), np.arange(height))
        valid = final_mask
        x, y, depth = x[valid], y[valid], depth_est_averaged[valid]
        color = ref_img[valid]
        xyz_ref = np.matmul(np.linalg.inv(ref_intr),
                            np.vstack((x, y, np.ones_like(x))) * depth)
        xyz_world = np.matmul(np.linalg.inv(ref_ext),
                              np.vstack((xyz_ref, np.ones_like(x))))[:3]
        vertexs.append(xyz_world.transpose(1, 0))
        vertex_colors.append((color * 255).astype(np.uint8))

    vertexs = np.concatenate(vertexs, axis=0)
    vertex_colors = np.concatenate(vertex_colors, axis=0)
    write_ply(plyfilename, vertexs, vertex_colors)
    log_fn(f"saved {len(vertexs)} points to {plyfilename}")
    return len(vertexs)


def dypcd_filter(datapath, outdir, testlist, conf=(0.1, 0.15, 0.9),
                 dist_base=0.25, rel_diff_base=1.0 / 1300, log_fn=print):
    """Fuse all scenes (parity: dypcd.py:384-397, incl. per-TnT-scene conf)."""
    for scene in testlist:
        scene_conf = conf
        if scene in TANK_CFG["scenes"]:
            scene_conf = TANK_CFG[scene]["conf"]
        pair_folder = os.path.join(datapath, scene)
        scan_folder = os.path.join(outdir, scene)
        filter_depth_dypcd(pair_folder, scan_folder, scan_folder,
                           os.path.join(outdir, f"{scene}.ply"),
                           conf=scene_conf, dist_base=dist_base,
                           rel_diff_base=rel_diff_base, log_fn=log_fn)
