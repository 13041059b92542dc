"""Tanks-and-Temples evaluation loader; counterpart of
damvsnet_tpu/data/tnt_eval.py, the same samples.

Per-scene native image sizes (1920/2048 x 1080, snapped to x32: height
1056), intrinsics divided by 4 at read, the 4-field depth line, per-scene
interval scales (the reference's tnt_eval_trans.py). Images through
``core.imageio``; cv2 resizes only where the snapped size differs.
"""
from __future__ import annotations

import os

from .general_eval import (build_metas, eval_sample, packed_proj, read_eval_cam_file,
                           read_eval_image, scale_mvs_input, sweep)

IMAGE_SIZES = {
    "Family": (1920, 1080), "Francis": (1920, 1080), "Horse": (1920, 1080),
    "Lighthouse": (2048, 1080), "M60": (2048, 1080), "Panther": (2048, 1080),
    "Playground": (1920, 1080), "Train": (1920, 1080),
    "Auditorium": (1920, 1080), "Ballroom": (1920, 1080),
    "Courtroom": (1920, 1080), "Museum": (1920, 1080),
    "Palace": (1920, 1080), "Temple": (1920, 1080),
}


class TnTEvalDataset:
    def __init__(self, datapath, listfile, mode, nviews, ndepths=192,
                 interval_scale=1.0, max_h=704, max_w=1280, **kwargs):
        assert mode == "test"
        self.datapath = datapath
        self.nviews = nviews
        self.ndepths = ndepths
        self.max_h = max_h
        self.max_w = max_w
        self.scans = listfile
        if isinstance(interval_scale, float):
            self.interval_scale = {s: interval_scale for s in listfile}
        else:
            self.interval_scale = interval_scale
        self.metas = build_metas(datapath, listfile, nviews)

    def __len__(self):
        return len(self.metas)

    def __getitem__(self, idx):
        scan, ref_view, src_views, scene_name = self.metas[idx]
        nviews = min(self.nviews, len(src_views) + 1)
        view_ids = [ref_view] + src_views[: nviews - 1]

        imgs, proj_matrices = [], []
        depth_values = intrinsics = None
        for i, vid in enumerate(view_ids):
            img = read_eval_image(os.path.join(self.datapath, f"{scan}/images/{vid:0>8}.jpg"))
            intrinsics, extrinsics, depth_min, depth_interval = read_eval_cam_file(
                os.path.join(self.datapath, f"{scan}/cams/{vid:0>8}_cam.txt"),
                self.interval_scale[scene_name], self.ndepths)
            max_w, max_h = IMAGE_SIZES.get(scan, (self.max_w, self.max_h))
            img, intrinsics = scale_mvs_input(img, intrinsics, max_w, max_h)
            imgs.append(img)
            proj_matrices.append(packed_proj(extrinsics, intrinsics))
            if i == 0:
                depth_values = sweep(depth_min, depth_interval, self.ndepths)
        return eval_sample(imgs, proj_matrices, intrinsics, depth_values, scan, view_ids[0])
