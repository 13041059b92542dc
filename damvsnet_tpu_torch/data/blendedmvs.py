"""BlendedMVS (low-res) fine-tuning loader (copy of
damvsnet_tpu/data/blendedmvs.py).

The reference's datasets/blendedmvs.py: cams/pair.txt clusters
(skip refs with < nviews-1 sources), ColorJitter + motion-blur train
augmentation, GT depth+mask from rendered_depth_maps (mask = depth >=
depth_min), per-stage K scaling x0.25/x0.5/x1 (features run at native
resolution). The reference fills ``intrinsics_matrices`` with projection
matrices by mistake (blendedmvs.py:202-206, harmless since the "z"
geo-encoding never reads K); here it carries the actual per-stage K. The
cam files are read by ``core.cameras.read_cam_file`` (the JAX loader's
own reader computes the same). cv2 and PIL are imported where they are
used, as in the DTU loader.
"""
from __future__ import annotations

import os

import numpy as np

from ..core.cameras import read_cam_file
from ..core.pfm import read_pfm
from .common import color_jitter, motion_blur


def _stage_pyramid(img):
    import cv2
    h, w = img.shape
    return {
        "stage1": cv2.resize(img, (w // 4, h // 4), interpolation=cv2.INTER_NEAREST),
        "stage2": cv2.resize(img, (w // 2, h // 2), interpolation=cv2.INTER_NEAREST),
        "stage3": img,
    }


class BlendedMVSDataset:
    def __init__(self, datapath, listfile, mode, nviews, ndepths=128,
                 interval_scale=1.06, seed: int = 0, **kwargs):
        self.datapath = datapath
        self.listfile = listfile
        self.mode = mode
        self.nviews = nviews
        self.ndepths = ndepths
        self.interval_scale = interval_scale
        self.rs = np.random.default_rng(seed)
        self.metas = self._build_list()

    def _build_list(self):
        metas = []
        with open(self.listfile) as f:
            scenes = [line.rstrip() for line in f if line.strip()]
        for data_name in scenes:
            cluster_path = os.path.join(self.datapath, data_name, "cams", "pair.txt")
            lines = open(cluster_path).read().splitlines()
            image_num = int(lines[0])
            for idx in range(image_num):
                ref_id = int(lines[2 * idx + 1])
                info = lines[2 * idx + 2].rstrip().split()
                if int(info[0]) < self.nviews - 1:
                    continue
                src_ids = [int(x) for x in info[1::2]]
                metas.append((data_name, ref_id, src_ids))
        return metas

    def __len__(self):
        return len(self.metas)

    def _read_img(self, filename):
        from PIL import Image
        img = np.asarray(Image.open(filename), dtype=np.float32)
        if self.mode == "train":
            img = color_jitter(img, self.rs)
            img = motion_blur(img, self.rs)
        return img / 255.0

    def __getitem__(self, idx):
        data_name, ref_id, src_ids = self.metas[idx]
        view_ids = [ref_id] + src_ids[: self.nviews - 1]

        imgs = []
        proj_matrices = []
        depth_ms = mask_ms = depth_values = None
        intrinsics = None
        for i, vid in enumerate(view_ids):
            img_path = os.path.join(self.datapath, data_name, "blended_images",
                                    f"{vid:08d}.jpg")
            cam_path = os.path.join(self.datapath, data_name, "cams",
                                    f"{vid:08d}_cam.txt")
            imgs.append(self._read_img(img_path))
            intrinsics, extrinsics, depth_min, depth_interval = read_cam_file(
                cam_path, interval_scale=self.interval_scale)
            proj = np.zeros((2, 4, 4), np.float32)
            proj[0] = extrinsics
            proj[1, :3, :3] = intrinsics
            proj_matrices.append(proj)

            if i == 0:
                depth_path = os.path.join(self.datapath, data_name,
                                          "rendered_depth_maps", f"{vid:08d}.pfm")
                depth = np.asarray(read_pfm(depth_path)[0], np.float32)
                mask = (depth >= depth_min).astype(np.float32)
                depth_ms = _stage_pyramid(depth)
                mask_ms = _stage_pyramid(mask)
                depth_values = np.arange(
                    depth_min, depth_interval * (self.ndepths - 0.5) + depth_min,
                    depth_interval, dtype=np.float32)

        imgs = np.stack(imgs).astype(np.float32)
        proj_matrices = np.stack(proj_matrices)

        # native-res features: stage K scaling is x0.25 / x0.5 / x1
        proj_ms = {}
        intr_ms = {}
        for sname, f in (("stage1", 0.25), ("stage2", 0.5), ("stage3", 1.0)):
            p = proj_matrices.copy()
            p[:, 1, :2, :] *= f
            proj_ms[sname] = p
            k = intrinsics.copy()
            k[:2, :] *= f
            intr_ms[sname] = k
        return {
            "imgs": imgs,
            "proj_matrices": proj_ms,
            "depth": depth_ms,
            "depth_values": depth_values,
            "intrinsics_matrices": intr_ms,
            "mask": mask_ms,
        }
