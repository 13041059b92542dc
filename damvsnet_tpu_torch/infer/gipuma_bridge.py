"""Gipuma-format bridge + fusibile-equivalent fusion dispatch; a copy of
damvsnet_tpu/infer/gipuma_bridge.py whose fusion is fusion_device.py.

Capability parity with the reference's gipuma.py:

  * probability_filter (:153-167): zero out depth where confidence < thr.
  * mvsnet_to_gipuma (:111-150): cams -> 3x4 P-matrix '.P' files, PFM depth
    -> Gipuma '.dmb' binaries + constant fake normals, image folder layout.
  * fusion: the reference shells out to the external CUDA ``fusibile``
    binary (:170-189). Here the equivalent consistency fusion
    (disp_thresh / num_consistent semantics) runs as the device-batched
    consistency filter (fusion_device.py) — no external binary. The format
    conversion is still provided so users can interoperate with real
    Gipuma outputs/inputs.
"""
from __future__ import annotations

import os
import shutil

import numpy as np

from ..core.pfm import read_pfm
from .fusion_dypcd import read_camera_parameters
from ..core.pairs import read_pair_file


def write_gipuma_dmb(path, image: np.ndarray):
    """Write a Gipuma .dmb binary (int32 type/h/w/c header + float32 data)."""
    image = np.asarray(image, dtype=np.float32)
    if image.ndim == 2:
        h, w = image.shape
        c = 1
    else:
        h, w, c = image.shape
    with open(path, "wb") as f:
        np.array([1, h, w, c], dtype=np.int32).tofile(f)
        image.tofile(f)


def read_gipuma_dmb(path):
    with open(path, "rb") as f:
        _type, h, w, c = np.fromfile(f, dtype=np.int32, count=4)
        data = np.fromfile(f, dtype=np.float32)
    return data.reshape(h, w, c).squeeze()


def write_gipuma_cam(path, intrinsics, extrinsics):
    """3x4 projection matrix P = K @ E[:3] as a '.P' text file."""
    p = intrinsics @ extrinsics[:3, :4]
    with open(path, "w") as f:
        for row in p:
            f.write(" ".join(str(v) for v in row) + "\n")
        f.write("\n")


def fake_colmap_normal(depth: np.ndarray) -> np.ndarray:
    """Constant (0, 0, -1)-ish normals where depth valid (gipuma.py:90-108)."""
    h, w = depth.shape
    normal = np.zeros((h, w, 3), dtype=np.float32)
    normal[:, :, 2] = -1.0
    normal[depth <= 0] = 0
    return normal


def probability_filter(scan_folder, out_folder, prob_threshold: float):
    """Zero depth below the confidence threshold; writes *_prob_filtered.pfm
    (gipuma.py:153-167)."""
    from ..core.pfm import write_pfm
    pair_data = read_pair_file(os.path.join(scan_folder, "pair.txt")) \
        if os.path.exists(os.path.join(scan_folder, "pair.txt")) else None
    depth_dir = os.path.join(out_folder, "depth_est")
    for name in sorted(os.listdir(depth_dir)):
        if not name.endswith(".pfm") or "stage" in name or "prob_filtered" in name:
            continue
        view = name[:-4]
        depth = read_pfm(os.path.join(depth_dir, name))[0]
        conf = read_pfm(os.path.join(out_folder, f"confidence/{view}.pfm"))[0]
        depth[conf < prob_threshold] = 0
        write_pfm(os.path.join(depth_dir, f"{view}_prob_filtered.pfm"),
                  depth.astype(np.float32))


def mvsnet_to_gipuma(scan_folder, out_folder, gipuma_root):
    """Convert a scene's outputs to the Gipuma folder layout
    (gipuma.py:111-150): <root>/cams/*.P, <root>/images/*, per-view
    2333_XXX/depths dmb + normals dmb."""
    cam_dir = os.path.join(gipuma_root, "cams")
    image_dir = os.path.join(gipuma_root, "images")
    os.makedirs(cam_dir, exist_ok=True)
    os.makedirs(image_dir, exist_ok=True)

    src_cam_dir = os.path.join(scan_folder, "cams")
    for name in sorted(os.listdir(src_cam_dir)):
        if not name.endswith("_cam.txt"):
            continue
        view = name.split("_")[0]
        intr, ext = read_camera_parameters(os.path.join(src_cam_dir, name))
        write_gipuma_cam(os.path.join(cam_dir, f"{view}.jpg.P"), intr, ext)

    src_img_dir = os.path.join(scan_folder, "images")
    for name in sorted(os.listdir(src_img_dir)):
        shutil.copy(os.path.join(src_img_dir, name),
                    os.path.join(image_dir, name))

    depth_dir = os.path.join(out_folder, "depth_est")
    for name in sorted(os.listdir(depth_dir)):
        if not name.endswith("_prob_filtered.pfm"):
            continue
        view = name.split("_")[0]
        sub = os.path.join(gipuma_root, f"2333_{view}")
        os.makedirs(sub, exist_ok=True)
        depth = read_pfm(os.path.join(depth_dir, name))[0]
        write_gipuma_dmb(os.path.join(sub, "disp.dmb"), depth)
        write_gipuma_dmb(os.path.join(sub, "normals.dmb"),
                         fake_colmap_normal(depth))


def gipuma_filter(datapath, outdir, testlist, prob_threshold=0.1,
                  disp_threshold=0.15, num_consistent=3, log_fn=print, device=None):
    """fusibile-equivalent pipeline: probability filter then device-batched
    consistency fusion with the fixed num_consistent acceptance
    (gipuma.py:192-213 semantics, no external CUDA binary) on ``device``
    (CUDA unless named)."""
    from .fusion_device import consistency_filter
    for scene in testlist:
        probability_filter(os.path.join(datapath, scene),
                           os.path.join(outdir, scene), prob_threshold)
    # disp_threshold acts as the reprojection tolerance: fusibile checks
    # disparity agreement; the equivalent here is the relative-depth check.
    consistency_filter(datapath, outdir, testlist,
                       conf=(0.0, 0.0, prob_threshold),
                       dist_base=1.0, rel_diff_base=disp_threshold / 10.0,
                       num_consistent=num_consistent, log_fn=log_fn, device=device)
