"""Procedural multi-view scene generator (numpy only).

A copy of ``make_synthetic_sample``, ``export_synthetic_scene`` and what
they need from damvsnet_tpu/data/synthetic.py: a slanted textured world
plane rendered from an N-camera rig with exact analytic depth, so every
image is geometrically consistent. Output dict layout matches the DTU
loader; the exported scene is in the eval layout ``general_eval`` reads.
"""
from __future__ import annotations

import os

import numpy as np

from ..core import imageio
from ..core.cameras import stage_intrinsics, stage_proj_matrices, write_cam_file
from ..core.pairs import write_pair_file
from ..core.pfm import write_pfm


def _texture(wx, wy):
    # low-frequency base + mid-frequency detail bands, capped below the
    # stage-1 (quarter-res) Nyquist of the default rigs: the renderer is
    # point-sampled, so higher bands would alias at stage 1
    r = (0.5 + 0.17 * np.sin(3.0 * wx) + 0.17 * np.cos(2.3 * wy + 1.7 * wx)
         + 0.08 * np.sin(12.3 * wx + 4.1 * wy) + 0.08 * np.cos(16.7 * wy))
    g = (0.5 + 0.17 * np.sin(1.3 * wx + 2.1 * wy) + 0.17 * np.cos(4.1 * wy)
         + 0.08 * np.sin(15.9 * wy - 6.3 * wx) + 0.08 * np.cos(17.3 * wx))
    b = (0.5 + 0.17 * np.sin(2.7 * wx * wy * 0.3) + 0.17 * np.cos(1.9 * wx)
         + 0.08 * np.sin(14.3 * wx + 7.7 * wy) + 0.08 * np.cos(13.9 * wy))
    return np.stack([r, g, b], axis=-1).astype(np.float32)


def _render_plane(intr, ext, height, width, plane_n, plane_c):
    """Render the plane n.X = c from camera (K, E). Returns (img, depth)."""
    kinv = np.linalg.inv(intr)
    rot = ext[:3, :3]
    t = ext[:3, 3]
    cam_center = -rot.T @ t  # world-frame camera center
    ys, xs = np.meshgrid(np.arange(height, dtype=np.float64),
                         np.arange(width, dtype=np.float64), indexing="ij")
    pix = np.stack([xs, ys, np.ones_like(xs)], axis=-1)  # [H,W,3]
    dirs_cam = pix @ kinv.T  # [H,W,3] camera-frame ray dirs (z=1)
    dirs_world = dirs_cam @ rot  # R^T @ d
    denom = dirs_world @ plane_n
    tt = (plane_c - cam_center @ plane_n) / denom  # [H,W]
    pts = cam_center[None, None, :] + tt[..., None] * dirs_world
    depth = tt * dirs_cam[..., 2]  # camera-frame z = t * dz_cam (dz_cam == 1)
    img = _texture(pts[..., 0], pts[..., 2])
    return img.astype(np.float32), depth.astype(np.float32)


def render_synthetic_views(height=128, width=160, nviews=3, seed=0):
    """Render all views of one scene. Returns a dict with imgs [N,H,W,3],
    depths [N,H,W] (per-view GT), intr (3,3 full-res), exts [N,4,4]."""
    rs = np.random.default_rng(seed)
    f = 0.9 * width
    intr = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]],
                    dtype=np.float32)
    # plane roughly facing the rig at distance ~6 with a random tilt
    tilt = 0.15 * rs.standard_normal(2)
    plane_n = np.array([tilt[0], tilt[1], 1.0])
    plane_n /= np.linalg.norm(plane_n)
    plane_c = 6.0

    imgs, depths, exts = [], [], []
    for v in range(nviews):
        angle = 0.04 * v + 0.01 * rs.standard_normal()
        ca, sa = np.cos(angle), np.sin(angle)
        rot = np.array([[ca, 0, sa], [0, 1, 0], [-sa, 0, ca]], dtype=np.float64)
        t = np.array([0.25 * v + 0.02 * rs.standard_normal(),
                      0.05 * v, 0.0])
        ext = np.eye(4, dtype=np.float32)
        ext[:3, :3] = rot
        ext[:3, 3] = t
        img, depth = _render_plane(intr.astype(np.float64), ext.astype(np.float64),
                                   height, width, plane_n, plane_c)
        imgs.append(img)
        depths.append(depth)
        exts.append(ext)
    return {
        "imgs": np.stack(imgs),
        "depths": np.stack(depths),
        "intr": intr,
        "exts": np.stack(exts),
    }


def make_synthetic_sample(height=128, width=160, nviews=3, ndepths=48,
                          seed=0, with_gt=True, ref_view=None):
    """One sample. ref_view rotates which camera is the reference (default:
    seed-derived). With ``with_gt`` the ground-truth depth pyramid is the
    nearest-neighbour downsample of the full-resolution depth."""
    scene = render_synthetic_views(height, width, nviews, seed)
    if ref_view is None:
        ref_view = seed % nviews
    order = [ref_view] + [v for v in range(nviews) if v != ref_view]
    imgs = scene["imgs"][order]
    depth_full = scene["depths"][ref_view]
    projs = []
    for v in order:
        proj = np.zeros((2, 4, 4), np.float32)
        proj[0] = scene["exts"][v]
        # stage-1 convention: cam files carry quarter-res K
        k1 = scene["intr"].copy()
        k1[:2] /= 4.0
        proj[1, :3, :3] = k1
        projs.append(proj)
    projs = np.stack(projs)
    dmin = float(depth_full.min()) * 0.9
    dmax = float(depth_full.max()) * 1.1
    depth_values = np.linspace(dmin, dmax, ndepths, dtype=np.float32)

    sample = {
        "imgs": imgs,
        "proj_matrices": stage_proj_matrices(projs),
        "depth_values": depth_values,
        "intrinsics_matrices": stage_intrinsics(projs[0, 1, :3, :3]),
        "filename": "synthetic/{}/" + f"{seed:0>8}" + "{}",
    }
    if with_gt:
        # nearest downsample by an integer factor keeps pixel (f*i, f*j)
        pyr = {"stage1": depth_full[::4, ::4].copy(),
               "stage2": depth_full[::2, ::2].copy(),
               "stage3": depth_full}
        sample["depth"] = pyr
        sample["mask"] = {k: np.ones_like(v) for k, v in pyr.items()}
    return sample


def export_synthetic_scene(datapath, scan="scan_synth", height=128, width=160,
                           nviews=5, seed=10_000, num_depth=192):
    """Write one synthetic scene in the MVSNet eval layout
    (images/{v:08d}.jpg, cams/{v:08d}_cam.txt with full-resolution K and a
    4-field depth line, pair.txt: every view a reference with all others as
    sources) plus ground truth: gt_depths/{v:08d}.pfm and gt_points.npy,
    every view's depth backprojected to world points (the synthetic
    stand-in for a DTU STL cloud). The same files as
    damvsnet_tpu/data/synthetic.py:147-211 writes. Returns the scene
    directory."""
    scene = render_synthetic_views(height, width, nviews, seed)
    base = os.path.join(datapath, scan)
    for sub in ("images", "cams", "gt_depths"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)

    gt_points = []
    for v in range(nviews):
        img = (np.clip(scene["imgs"][v], 0, 1) * 255).astype(np.uint8)
        # q100 with 4:4:4 chroma: 4:2:0 blur would be matching noise that
        # measures the codec, not the network
        imageio.write_rgb(os.path.join(base, f"images/{v:08d}.jpg"), img,
                          quality=100, chroma_444=True)
        # per-view depth range, as DTU's cam files have
        dmin = float(scene["depths"][v].min()) * 0.9
        dmax = float(scene["depths"][v].max()) * 1.1
        interval = (dmax - dmin) / num_depth
        write_cam_file(os.path.join(base, f"cams/{v:08d}_cam.txt"),
                       scene["intr"], scene["exts"][v], dmin, interval,
                       num_depth=num_depth, depth_max=dmax)
        write_pfm(os.path.join(base, f"gt_depths/{v:08d}.pfm"), scene["depths"][v])
        h, w = scene["depths"][v].shape
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        pix = np.stack([xs, ys, np.ones_like(xs)], -1).reshape(-1, 3)
        kinv = np.linalg.inv(scene["intr"].astype(np.float64))
        cam = (pix @ kinv.T) * scene["depths"][v].reshape(-1, 1)
        ext = scene["exts"][v].astype(np.float64)
        gt_points.append((cam - ext[:3, 3]) @ ext[:3, :3])  # R^T (x - t)
    np.save(os.path.join(base, "gt_points.npy"),
            np.concatenate(gt_points, 0).astype(np.float32))
    write_pair_file(os.path.join(base, "pair.txt"),
                    [(v, [s for s in range(nviews) if s != v]) for v in range(nviews)])
    return base


class SyntheticDataset:
    """The synthetic scene as a dataset (damvsnet_tpu/data/synthetic.py:
    213-230): sample k is ``make_synthetic_sample(seed=k)``. The path,
    list and interval arguments of the real datasets are accepted and
    unused."""

    def __init__(self, datapath=None, listfile=None, mode="train", nviews=3,
                 ndepths=48, interval_scale=1.0, height=128, width=160,
                 length=16):
        self.nviews = nviews
        self.ndepths = ndepths
        self.height = height
        self.width = width
        self.length = length
        self.mode = mode

    def __len__(self):
        return self.length

    def __getitem__(self, idx):
        return make_synthetic_sample(self.height, self.width, self.nviews,
                                     self.ndepths, seed=idx,
                                     with_gt=self.mode != "test")
