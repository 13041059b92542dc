"""Generic evaluation loader (DTU test, any MVSNet-format scene);
counterpart of damvsnet_tpu/data/general_eval.py, the same samples.

Intrinsics are divided by 4 at read (cam files carry full-resolution K),
images are scaled and snapped to multiples of 32 under (max_h, max_w),
interval scales are per scene, depth_values is an arange over ndepths - 0.5
intervals, and ``filename`` is the template the depth writer fills in.

Images are read through ``core.imageio`` (PIL). The resize is cv2's, as in
the JAX package, but only where the snapped size differs from the image's:
at equal size cv2.resize returns its input unchanged, so skipping it gives
the same sample, and a 1152x864 scene loads without cv2.
"""
from __future__ import annotations

import os

import numpy as np

from ..core import imageio
from ..core.cameras import read_cam_file, stage_intrinsics, stage_proj_matrices
from ..core.pairs import read_pair_file


def scale_mvs_input(img, intrinsics, max_w, max_h, base=32):
    """Snap the image to multiples of ``base`` under the max size, rescaling
    K (the reference's general_eval.py:92-109)."""
    h, w = img.shape[:2]
    if h > max_h or w > max_w:
        scale = 1.0 * max_h / h
        if scale * w > max_w:
            scale = 1.0 * max_w / w
        new_w, new_h = scale * w // base * base, scale * h // base * base
    else:
        new_w, new_h = 1.0 * w // base * base, 1.0 * h // base * base
    scale_w = 1.0 * new_w / w
    scale_h = 1.0 * new_h / h
    intrinsics = intrinsics.copy()
    intrinsics[0, :] *= scale_w
    intrinsics[1, :] *= scale_h
    if (int(new_w), int(new_h)) != (w, h):
        import cv2
        img = cv2.resize(img, (int(new_w), int(new_h)))
    return img, intrinsics


def read_eval_cam_file(filename, interval_scale, ndepths):
    """(K / 4, E, depth_min, depth_interval) of an eval cam file: with a
    num_depth field the interval is re-derived for ``ndepths`` hypotheses
    over the same range, then scaled (general_eval.py:59-79)."""
    intrinsics, extrinsics, depth_min, depth_interval = read_cam_file(
        filename, interval_scale, ndepths)
    intrinsics[:2, :] /= 4.0
    return intrinsics, extrinsics, depth_min, depth_interval


def read_eval_image(filename):
    """float32 [H, W, 3] in [0, 1]."""
    return imageio.read_rgb(filename).astype(np.float32) / 255.0


def build_metas(datapath, scans, nviews):
    """(scan, ref_view, src_views, scan) for every reference of every scan;
    a short source list is padded with its first view."""
    metas = []
    for scan in scans:
        for ref_view, src_views in read_pair_file(os.path.join(datapath, scan, "pair.txt")):
            if len(src_views) < nviews:
                src_views = src_views + [src_views[0]] * (nviews - len(src_views))
            metas.append((scan, ref_view, src_views, scan))
    return metas


def eval_sample(imgs, proj_matrices, intrinsics, depth_values, scan, ref_view):
    proj_matrices = np.stack(proj_matrices)
    return {
        "imgs": np.stack(imgs).astype(np.float32),
        "proj_matrices": stage_proj_matrices(proj_matrices),
        "depth_values": depth_values,
        "intrinsics_matrices": stage_intrinsics(intrinsics),
        "filename": scan + "/{}/" + f"{ref_view:0>8}" + "{}",
    }


def packed_proj(extrinsics, intrinsics):
    proj = np.zeros((2, 4, 4), np.float32)
    proj[0] = extrinsics
    proj[1, :3, :3] = intrinsics
    return proj


def sweep(depth_min, depth_interval, ndepths):
    return np.arange(depth_min, depth_interval * (ndepths - 0.5) + depth_min,
                     depth_interval, dtype=np.float32)


class GeneralEvalDataset:
    def __init__(self, datapath, listfile, mode, nviews, ndepths=192,
                 interval_scale=1.06, **kwargs):
        assert mode == "test"
        self.datapath = datapath
        self.listfile = listfile  # list of scan names
        self.nviews = nviews
        self.ndepths = ndepths
        self.max_h = kwargs["max_h"]
        self.max_w = kwargs["max_w"]
        self.fix_res = kwargs.get("fix_res", False)
        self.fix_wh = False
        self.s_h, self.s_w = 0, 0
        if isinstance(interval_scale, float):
            self.interval_scale = {s: interval_scale for s in listfile}
        else:
            self.interval_scale = interval_scale
        self.metas = build_metas(datapath, listfile, nviews)

    def __len__(self):
        return len(self.metas)

    def __getitem__(self, idx):
        scan, ref_view, src_views, scene_name = self.metas[idx]
        view_ids = [ref_view] + src_views[: self.nviews - 1]

        imgs, proj_matrices = [], []
        depth_values = intrinsics = None
        for i, vid in enumerate(view_ids):
            img_filename = os.path.join(self.datapath, f"{scan}/images_post/{vid:0>8}.jpg")
            if not os.path.exists(img_filename):
                img_filename = os.path.join(self.datapath, f"{scan}/images/{vid:0>8}.jpg")
            cam_filename = os.path.join(self.datapath, f"{scan}/cams/{vid:0>8}_cam.txt")

            img = read_eval_image(img_filename)
            intrinsics, extrinsics, depth_min, depth_interval = read_eval_cam_file(
                cam_filename, self.interval_scale[scene_name], self.ndepths)
            img, intrinsics = scale_mvs_input(img, intrinsics, self.max_w, self.max_h)

            if self.fix_res:
                self.s_h, self.s_w = img.shape[:2]
                self.fix_res = False
                self.fix_wh = True
            if i == 0 and not self.fix_wh:
                self.s_h, self.s_w = img.shape[:2]
            c_h, c_w = img.shape[:2]
            if (c_h, c_w) != (self.s_h, self.s_w):
                import cv2
                intrinsics[0, :] *= 1.0 * self.s_w / c_w
                intrinsics[1, :] *= 1.0 * self.s_h / c_h
                img = cv2.resize(img, (self.s_w, self.s_h))

            imgs.append(img)
            proj_matrices.append(packed_proj(extrinsics, intrinsics))
            if i == 0:
                depth_values = sweep(depth_min, depth_interval, self.ndepths)
        return eval_sample(imgs, proj_matrices, intrinsics, depth_values, scan, view_ids[0])
