"""Classic fixed-threshold point-cloud fusion ("pcd"); a copy of
damvsnet_tpu/infer/fusion_pcd.py (host numpy; images through core.imageio).

Parity with the reference's filter/pcd.py: single consistency threshold
(reprojection dist < 1 px AND relative depth diff < 0.01), geo vote
geo_mask_sum >= thres_view, 3-stage confidence photo mask, averaged depth
backprojection to a colored world-frame PLY.
"""
from __future__ import annotations

import os

import numpy as np

from ..core import imageio
from ..core.pairs import read_pair_file
from ..core.pfm import read_pfm
from ..core.ply import write_ply
from .fusion_dypcd import read_camera_parameters, reproject_with_depth
from .tank_config import TANK_CFG


def check_geometric_consistency(depth_ref, intr_ref, ext_ref, depth_src,
                                intr_src, ext_src):
    """(parity: filter/pcd.py:98-113)."""
    height, width = depth_ref.shape
    x_ref, y_ref = np.meshgrid(np.arange(width), np.arange(height))
    depth_reproj, x2d_reproj, y2d_reproj, x2d_src, y2d_src = \
        reproject_with_depth(depth_ref, intr_ref, ext_ref, depth_src,
                             intr_src, ext_src)
    dist = np.sqrt((x2d_reproj - x_ref) ** 2 + (y2d_reproj - y_ref) ** 2)
    relative_depth_diff = np.abs(depth_reproj - depth_ref) / depth_ref
    mask = np.logical_and(dist < 1, relative_depth_diff < 0.01)
    depth_reproj[~mask] = 0
    return mask, depth_reproj, x2d_src, y2d_src


def filter_depth_pcd(pair_folder, scan_folder, out_folder, plyfilename,
                     conf=(0.1, 0.15, 0.9), thres_view: int = 5,
                     num_stage: int = 3, log_fn=print):
    pair_data = read_pair_file(os.path.join(pair_folder, "pair.txt"))
    vertexs, vertex_colors = [], []
    for ref_view, src_views in pair_data:
        ref_intr, ref_ext = read_camera_parameters(
            os.path.join(scan_folder, f"cams/{ref_view:0>8}_cam.txt"))
        ref_img = imageio.read_rgb(
            os.path.join(scan_folder, f"images/{ref_view:0>8}.jpg")).astype(np.float32) / 255.0
        ref_depth_est = read_pfm(
            os.path.join(out_folder, f"depth_est/{ref_view:0>8}.pfm"))[0]
        c3 = read_pfm(os.path.join(out_folder, f"confidence/{ref_view:0>8}.pfm"))[0]
        c2 = read_pfm(os.path.join(out_folder,
                                   f"confidence/{ref_view:0>8}_stage2.pfm"))[0]
        c1 = read_pfm(os.path.join(out_folder,
                                   f"confidence/{ref_view:0>8}_stage1.pfm"))[0]
        photo_mask = (c3 > conf[2]) & (c2 > conf[1]) & (c1 > conf[0])

        all_depths = []
        geo_mask_sum = 0
        for src_view in src_views:
            src_intr, src_ext = read_camera_parameters(
                os.path.join(scan_folder, f"cams/{src_view:0>8}_cam.txt"))
            src_depth_est = read_pfm(
                os.path.join(out_folder, f"depth_est/{src_view:0>8}.pfm"))[0]
            geo_mask, depth_reproj, _, _ = check_geometric_consistency(
                ref_depth_est, ref_intr, ref_ext, src_depth_est, src_intr, src_ext)
            geo_mask_sum += geo_mask.astype(np.int32)
            all_depths.append(depth_reproj)

        depth_avg = (sum(all_depths) + ref_depth_est) / (geo_mask_sum + 1)
        geo_mask = geo_mask_sum >= thres_view
        final_mask = np.logical_and(photo_mask, geo_mask)

        height, width = depth_avg.shape
        x, y = np.meshgrid(np.arange(width), np.arange(height))
        x, y, depth = x[final_mask], y[final_mask], depth_avg[final_mask]
        if num_stage == 1:
            color = ref_img[1::4, 1::4, :][final_mask]
        elif num_stage == 2:
            color = ref_img[1::2, 1::2, :][final_mask]
        else:
            color = ref_img[final_mask]
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


def pcd_filter(datapath, outdir, testlist, conf=(0.1, 0.15, 0.9),
               thres_view: int = 5, dtu_naming: bool = True, log_fn=print):
    """Fuse every scene (parity: pcd.py:238-259 incl. DTU mvsnetXXX naming)."""
    for scan in testlist:
        scene_conf = conf
        if scan in TANK_CFG["scenes"]:
            scene_conf = TANK_CFG[scan]["conf"]
        if dtu_naming and scan.startswith("scan"):
            save_name = f"mvsnet{int(scan[4:]):0>3}_l3.ply"
        else:
            save_name = f"{scan}.ply"
        filter_depth_pcd(os.path.join(datapath, scan),
                         os.path.join(outdir, scan), os.path.join(outdir, scan),
                         os.path.join(outdir, save_name), conf=scene_conf,
                         thres_view=thres_view, log_fn=log_fn)
