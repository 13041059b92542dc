"""The camera model, MVSNet-format cam.txt IO and per-stage camera
matrices (copy of damvsnet_tpu/core/cameras.py), in numpy.

cam.txt (the reference's readers, datasets/dtu_yao.py:56-74 and
datasets/general_eval.py:59-79):

    extrinsic
    <4x4 world-to-camera matrix, rows on lines 1..4>
    <blank>
    intrinsic
    <3x3 K, rows on lines 7..9>
    <blank>
    depth_min depth_interval [num_depth [depth_max]]

Features are computed at 1/4, 1/2 and 1/1 of input resolution; per-stage
intrinsics scale rows 0..1 of K by 1/2/4 (reference:
datasets/dtu_yao.py:222-243).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Camera:
    """A pinhole camera: K (3x3 intrinsics) + E (4x4 world->cam extrinsics)."""

    intrinsics: np.ndarray  # (3, 3) float32
    extrinsics: np.ndarray  # (4, 4) float32
    depth_min: float = 0.0
    depth_interval: float = 0.0
    num_depth: int = 0
    depth_max: float = 0.0

    def proj_mat(self) -> np.ndarray:
        """3x4 projection matrix P = K @ E[:3]."""
        return (self.intrinsics @ self.extrinsics[:3, :4]).astype(np.float32)

    def scaled(self, scale_x: float, scale_y: float) -> "Camera":
        k = self.intrinsics.copy()
        k[0, :] *= scale_x
        k[1, :] *= scale_y
        return dataclasses.replace(self, intrinsics=k)


def read_cam_file(filename, interval_scale: float = 1.0, ndepths: int | None = None):
    """Parse a MVSNet cam.txt.

    Returns (intrinsics (3,3), extrinsics (4,4), depth_min, depth_interval).

    If the depth line has >= 3 entries (num_depth present) and `ndepths` is
    given, the interval is recomputed so that `ndepths` hypotheses span the
    same total range (reference: datasets/general_eval.py:72-77).
    `interval_scale` multiplies the interval (applied after the recompute,
    matching general_eval; dtu_yao applies it directly since its cam files
    have only 2 entries on the depth line).
    """
    with open(filename) as f:
        lines = [line.rstrip() for line in f.readlines()]
    extrinsics = np.fromstring(" ".join(lines[1:5]), dtype=np.float32, sep=" ").reshape(4, 4)
    intrinsics = np.fromstring(" ".join(lines[7:10]), dtype=np.float32, sep=" ").reshape(3, 3)
    fields = lines[11].split()
    depth_min = float(fields[0])
    depth_interval = float(fields[1])
    if len(fields) >= 3 and ndepths is not None:
        num_depth = int(float(fields[2]))
        depth_max = depth_min + num_depth * depth_interval
        depth_interval = (depth_max - depth_min) / ndepths
    depth_interval *= interval_scale
    return intrinsics, extrinsics, depth_min, depth_interval


def write_cam_file(filename, intrinsics, extrinsics, depth_min, depth_interval,
                   num_depth: int | None = None, depth_max: float | None = None):
    """Write a MVSNet cam.txt (inverse of read_cam_file)."""
    with open(filename, "w") as f:
        f.write("extrinsic\n")
        for row in np.asarray(extrinsics).reshape(4, 4):
            f.write(" ".join(f"{v:.6f}" for v in row) + "\n")
        f.write("\nintrinsic\n")
        for row in np.asarray(intrinsics).reshape(3, 3):
            f.write(" ".join(f"{v:.6f}" for v in row) + "\n")
        tail = f"\n{depth_min} {depth_interval}"
        if num_depth is not None:
            tail += f" {num_depth}"
            if depth_max is not None:
                tail += f" {depth_max}"
        f.write(tail + "\n")


def stage_intrinsics(intrinsics: np.ndarray, num_stages: int = 3):
    """Per-stage K dict: stage1 = K as given (1/4 res), stage_i rows 0..1 x 2^(i-1)."""
    out = {}
    for s in range(1, num_stages + 1):
        k = intrinsics.copy()
        k[:2, :] *= 2.0 ** (s - 1)
        out[f"stage{s}"] = k.astype(np.float32)
    return out


def stage_proj_matrices(proj: np.ndarray, num_stages: int = 3):
    """Per-stage (N, 2, 4, 4) proj matrices (ext in [0], K in [1, :3, :3]).

    Input holds stage-1 (quarter-res) intrinsics; stage_i scales K rows 0..1
    by 2^(i-1).
    """
    out = {}
    for s in range(1, num_stages + 1):
        p = proj.copy()
        p[..., 1, :2, :] = proj[..., 1, :2, :] * (2.0 ** (s - 1))
        out[f"stage{s}"] = p.astype(np.float32)
    return out


def fuse_proj(proj_2x4x4: np.ndarray) -> np.ndarray:
    """Fuse (.., 2, 4, 4) [extrinsics, K-padded] into a single (.., 4, 4)
    matrix M with M[:3,:4] = K @ E[:3,:4], M[3] = E[3] (the torch
    counterpart on the model's path is
    model/cascade.py::fuse_projection_matrices)."""
    proj = np.asarray(proj_2x4x4)
    ext = proj[..., 0, :, :]
    k = proj[..., 1, :3, :3]
    out = ext.copy()
    out[..., :3, :4] = k @ ext[..., :3, :4]
    return out.astype(np.float32)
