"""DTU training/validation loader (copy of damvsnet_tpu/data/dtu.py).

The reference's datasets/dtu_yao.py:
  * metas = scan x 49 ref views (Cameras/pair.txt) x 7 light conditions
  * rectified images are 640x512 PNGs scaled to [0, 1]
  * hi-res GT depth/mask: downsample x1/2 (nearest) then center-crop 512x640,
    then per-stage nearest pyramids (/4, /2, /1)
  * cam.txt from Cameras/train/, interval_scale applied to the interval
  * depth_values = arange(dmin, dmin + ndepths * interval)
  * per-stage K scaling x1 / x2 / x4 (the cam files carry quarter-res K)

Output layout: imgs [N, H, W, 3] float32 (NHWC). cv2 and PIL are imported
where they are used, so the package imports without them; a sample then
raises the ImportError that names the missing package.
"""
from __future__ import annotations

import os

import numpy as np

from ..core.cameras import read_cam_file, stage_intrinsics, stage_proj_matrices
from ..core.pfm import read_pfm


def _prepare_img(hr_img: np.ndarray) -> np.ndarray:
    """1600x1200 -> 800x600 (nearest) -> center crop 640x512
    (parity: dtu_yao.py:103-118)."""
    import cv2
    h, w = hr_img.shape
    ds = cv2.resize(hr_img, (w // 2, h // 2), interpolation=cv2.INTER_NEAREST)
    h, w = ds.shape
    th, tw = 512, 640
    sh, sw = (h - th) // 2, (w - tw) // 2
    return ds[sh:sh + th, sw:sw + tw]


def _stage_pyramid(img: np.ndarray) -> dict:
    import cv2
    h, w = img.shape
    return {
        "stage1": cv2.resize(img, (w // 4, h // 4), interpolation=cv2.INTER_NEAREST),
        "stage2": cv2.resize(img, (w // 2, h // 2), interpolation=cv2.INTER_NEAREST),
        "stage3": img,
    }


class DTUTrainDataset:
    def __init__(self, datapath, listfile, mode, nviews, ndepths=192,
                 interval_scale=1.06, **kwargs):
        assert mode in ("train", "val", "test")
        self.datapath = datapath
        self.listfile = listfile
        self.mode = mode
        self.nviews = nviews
        self.ndepths = ndepths
        self.interval_scale = interval_scale
        self.metas = self._build_list()

    def _build_list(self):
        with open(self.listfile) as f:
            scans = [line.rstrip() for line in f if line.strip()]
        metas = []
        pair_file = os.path.join(self.datapath, "Cameras/pair.txt")
        with open(pair_file) as f:
            num_viewpoint = int(f.readline())
            views = []
            for _ in range(num_viewpoint):
                ref_view = int(f.readline().rstrip())
                src_views = [int(x) for x in f.readline().rstrip().split()[1::2]]
                views.append((ref_view, src_views))
        for scan in scans:
            for ref_view, src_views in views:
                for light_idx in range(7):
                    metas.append((scan, light_idx, ref_view, src_views))
        return metas

    def __len__(self):
        return len(self.metas)

    @staticmethod
    def _read_img(filename):
        from PIL import Image
        return np.asarray(Image.open(filename), dtype=np.float32) / 255.0

    @staticmethod
    def _read_mask_hr(filename):
        from PIL import Image
        arr = np.asarray(Image.open(filename), dtype=np.float32)
        return (arr > 10).astype(np.float32)

    def __getitem__(self, idx):
        scan, light_idx, ref_view, src_views = self.metas[idx]
        view_ids = [ref_view] + src_views[: self.nviews - 1]

        imgs = []
        proj_matrices = []
        depth_ms = mask_ms = depth_values = None
        intrinsics = None
        for i, vid in enumerate(view_ids):
            img_filename = os.path.join(
                self.datapath,
                f"Rectified/{scan}_train/rect_{vid + 1:0>3}_{light_idx}_r5000.png")
            mask_filename = os.path.join(
                self.datapath, f"Depths_raw/{scan}/depth_visual_{vid:0>4}.png")
            depth_filename = os.path.join(
                self.datapath, f"Depths_raw/{scan}/depth_map_{vid:0>4}.pfm")
            cam_filename = os.path.join(
                self.datapath, f"Cameras/train/{vid:0>8}_cam.txt")

            imgs.append(self._read_img(img_filename))
            intrinsics, extrinsics, depth_min, depth_interval = read_cam_file(
                cam_filename, interval_scale=self.interval_scale)
            proj = np.zeros((2, 4, 4), np.float32)
            proj[0] = extrinsics
            proj[1, :3, :3] = intrinsics
            proj_matrices.append(proj)

            if i == 0:
                mask_hr = self._read_mask_hr(mask_filename)
                mask_ms = _stage_pyramid(_prepare_img(mask_hr))
                depth_hr = np.asarray(read_pfm(depth_filename)[0], np.float32)
                depth_ms = _stage_pyramid(_prepare_img(depth_hr))
                depth_max = depth_interval * self.ndepths + depth_min
                depth_values = np.arange(depth_min, depth_max, depth_interval,
                                         dtype=np.float32)

        imgs = np.stack(imgs).astype(np.float32)  # [N, H, W, 3]
        proj_matrices = np.stack(proj_matrices)
        return {
            "imgs": imgs,
            "proj_matrices": stage_proj_matrices(proj_matrices),
            "depth": depth_ms,
            "depth_values": depth_values,
            "intrinsics_matrices": stage_intrinsics(intrinsics),
            "mask": mask_ms,
        }
