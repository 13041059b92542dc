"""Synthetic multi-view scenes made from the seed: the benchmark's inputs.

A copy of the port's numpy renderer (``data/synthetic.py``: a slanted,
textured world plane seen by a rig of N cameras, with exact depth) that
renders on the device in fp64 and hands back numpy arrays, so a pool of
full-size scenes costs milliseconds of set-up. The scene's parameters are
drawn from ``numpy.random.default_rng`` in the numpy renderer's order;
every scene of every seed has the same sizes.
"""
from __future__ import annotations

import numpy as np
import torch


def _texture(wx, wy):
    sin, cos = torch.sin, torch.cos
    r = (0.5 + 0.17 * sin(3.0 * wx) + 0.17 * cos(2.3 * wy + 1.7 * wx)
         + 0.08 * sin(12.3 * wx + 4.1 * wy) + 0.08 * cos(16.7 * wy))
    g = (0.5 + 0.17 * sin(1.3 * wx + 2.1 * wy) + 0.17 * cos(4.1 * wy)
         + 0.08 * sin(15.9 * wy - 6.3 * wx) + 0.08 * cos(17.3 * wx))
    b = (0.5 + 0.17 * sin(2.7 * wx * wy * 0.3) + 0.17 * cos(1.9 * wx)
         + 0.08 * sin(14.3 * wx + 7.7 * wy) + 0.08 * cos(13.9 * wy))
    return torch.stack([r, g, b], dim=-1)


def render_views(height, width, nviews, rng, device):
    """imgs [N, H, W, 3] fp32, depths [N, H, W] fp32, intr [3, 3] (full
    resolution), exts [N, 4, 4], as numpy."""
    f = 0.9 * width
    intr = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]], dtype=np.float32)
    tilt = 0.15 * rng.standard_normal(2)
    plane_n = np.array([tilt[0], tilt[1], 1.0])
    plane_n /= np.linalg.norm(plane_n)
    plane_c = 6.0
    exts = []
    for v in range(nviews):
        angle = 0.04 * v + 0.01 * rng.standard_normal()
        ca, sa = np.cos(angle), np.sin(angle)
        ext = np.eye(4, dtype=np.float32)
        ext[:3, :3] = [[ca, 0, sa], [0, 1, 0], [-sa, 0, ca]]
        ext[:3, 3] = [0.25 * v + 0.02 * rng.standard_normal(), 0.05 * v, 0.0]
        exts.append(ext)
    exts = np.stack(exts)

    dd = dict(dtype=torch.float64, device=device)
    kinv = torch.linalg.inv(torch.tensor(intr, **dd))
    ext_t = torch.tensor(exts, **dd)
    rot, t = ext_t[:, :3, :3], ext_t[:, :3, 3]
    centers = -torch.einsum("vji,vj->vi", rot, t)  # -R^T t
    ys, xs = torch.meshgrid(torch.arange(height, **dd), torch.arange(width, **dd),
                            indexing="ij")
    dirs_cam = torch.stack([xs, ys, torch.ones_like(xs)], -1) @ kinv.T  # [H, W, 3]
    dirs_world = torch.einsum("hwi,vij->vhwj", dirs_cam, rot)  # R^T d
    n = torch.tensor(plane_n, **dd)
    tt = (plane_c - centers @ n)[:, None, None] / (dirs_world @ n)  # [V, H, W]
    pts = centers[:, None, None] + tt[..., None] * dirs_world
    imgs = _texture(pts[..., 0], pts[..., 2]).float()
    depths = (tt * dirs_cam[..., 2]).float()
    return imgs.cpu().numpy(), depths.cpu().numpy(), intr, exts


def stage_projections(exts, intr):
    """{stageK: [N, 2, 4, 4]}: extrinsics in slot 0, the stage's K in
    slot 1 (stage 1 at quarter resolution, x2 a stage)."""
    out = {}
    for s in (1, 2, 3):
        proj = np.zeros((len(exts), 2, 4, 4), np.float32)
        proj[:, 0] = exts
        k = intr.copy()
        k[:2] *= 2.0 ** (s - 1) / 4.0
        proj[:, 1, :3, :3] = k
        out[f"stage{s}"] = proj
    return out


def make_sample(height, width, nviews, ndepths, rng, device, with_gt):
    """One sample in the loaders' layout (imgs [N, H, W, 3],
    proj_matrices, depth_values [D0]; with ``with_gt`` the depth pyramid
    and an all-ones mask). The reference view is drawn from ``rng``."""
    imgs, depths, intr, exts = render_views(height, width, nviews, rng, device)
    ref = int(rng.integers(nviews))
    order = [ref] + [v for v in range(nviews) if v != ref]
    full = depths[ref]
    sample = {"imgs": imgs[order], "proj_matrices": stage_projections(exts[order], intr),
              "depth_values": np.linspace(float(full.min()) * 0.9, float(full.max()) * 1.1,
                                          ndepths, dtype=np.float32)}
    if with_gt:
        pyr = {"stage1": full[::4, ::4].copy(), "stage2": full[::2, ::2].copy(),
               "stage3": full}
        sample["depth"] = pyr
        sample["mask"] = {k: np.ones_like(v) for k, v in pyr.items()}
    return sample


def collate(samples):
    """Stack samples into a batch, recursing into dicts."""
    first = samples[0]
    return {k: collate([s[k] for s in samples]) if isinstance(first[k], dict)
            else np.stack([s[k] for s in samples]) for k in first}


def make_pool(seed, size, batch, height, width, nviews, ndepths, device, with_gt):
    """``size`` batches of ``batch`` samples, every sample its own scene,
    drawn from ``seed`` (any whole number)."""
    root = np.random.SeedSequence(seed % 2 ** 64)
    rngs = [np.random.default_rng(s) for s in root.spawn(size * batch)]
    return [collate([make_sample(height, width, nviews, ndepths, rngs[i * batch + j],
                                 device, with_gt) for j in range(batch)])
            for i in range(size)]
