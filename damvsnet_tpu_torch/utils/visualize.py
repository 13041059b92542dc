"""Depth / confidence / error visualization utilities; a copy of
damvsnet_tpu/utils/visualize.py (the same arrays out of the same arrays).

Capability parity with the reference's visualize.py (410 LoC of
matplotlib-based PFM->pseudo-color PNG export: ``visualization`` walks a
results directory, ``convertPNG`` colorizes 16-bit depth PNGs,
``DepthMapPseudoColorize`` maps one depth array) — reimplemented
dependency-light (numpy + PIL/cv2 only, no matplotlib figure machinery)
and extended with confidence and error-map rendering for debugging
training runs (the images the TB writer logs, train/logging.py).
"""
from __future__ import annotations

import os

import numpy as np


def _colormap(x: np.ndarray, name: str = "jet") -> np.ndarray:
    """x in [0, 1] -> float RGB in [0, 1]. Supported: jet, viridis-like
    ramp ("viridis"), grayscale ("gray"), signed blue-white-red
    ("coolwarm", expects x in [0, 1] with 0.5 = zero)."""
    x = np.clip(x, 0.0, 1.0)
    if name == "jet":
        r = np.clip(1.5 - np.abs(4 * x - 3), 0, 1)
        g = np.clip(1.5 - np.abs(4 * x - 2), 0, 1)
        b = np.clip(1.5 - np.abs(4 * x - 1), 0, 1)
    elif name == "viridis":
        # compact polynomial fit of the viridis ramp (visually close)
        r = np.clip(0.267 + x * (0.005 + x * (1.17 * x - 0.44)), 0, 1)
        g = np.clip(0.005 + x * (1.39 + x * (-0.80 + 0.31 * x)), 0, 1)
        b = np.clip(0.329 + x * (1.38 + x * (-3.05 + 1.48 * x)), 0, 1)
    elif name == "coolwarm":
        t = 2.0 * x - 1.0  # [-1, 1]
        r = np.clip(1.0 + np.minimum(t, 0.0), 0, 1)
        b = np.clip(1.0 - np.maximum(t, 0.0), 0, 1)
        g = np.minimum(r, b)
    else:  # gray
        r = g = b = x
    return np.stack([r, g, b], axis=-1)


def depth_to_color(depth: np.ndarray, dmin=None, dmax=None,
                   invalid_mask=None, cmap: str = "jet") -> np.ndarray:
    """Depth [H, W] -> uint8 RGB [H, W, 3] (invalid pixels black).

    Parity: DepthMapPseudoColorize (the reference's visualize.py:64-88) —
    range-normalized pseudo-color with optional fixed dmin/dmax."""
    d = np.asarray(depth, dtype=np.float64)
    if invalid_mask is None:
        invalid_mask = ~np.isfinite(d) | (d <= 0)
    valid = ~invalid_mask
    if dmin is None:
        dmin = d[valid].min() if valid.any() else 0.0
    if dmax is None:
        dmax = d[valid].max() if valid.any() else 1.0
    x = np.clip((np.nan_to_num(d) - dmin) / max(dmax - dmin, 1e-9), 0, 1)
    rgb = (_colormap(x, cmap) * 255).astype(np.uint8)
    rgb[invalid_mask] = 0
    return rgb


def confidence_to_color(conf: np.ndarray, threshold: float | None = None
                        ) -> np.ndarray:
    """Confidence [H, W] in [0, 1] -> uint8 RGB. With a threshold, pixels
    below it are dimmed red (the fusion's photo-mask rejects them)."""
    c = np.clip(np.nan_to_num(np.asarray(conf, np.float64)), 0, 1)
    rgb = (_colormap(c, "viridis") * 255).astype(np.uint8)
    if threshold is not None:
        rej = c < threshold
        rgb[rej] = (0.6 * rgb[rej] + 0.4 * np.array([255, 0, 0])).astype(np.uint8)
    return rgb


def error_to_color(depth_est: np.ndarray, depth_gt: np.ndarray,
                   mask: np.ndarray | None = None,
                   max_error: float = 8.0) -> np.ndarray:
    """|est - gt| -> uint8 RGB, saturating at max_error (mm); pixels
    outside the mask are black. The visual analog of the banded
    AbsDepthError metrics (train/metrics.py)."""
    err = np.abs(np.asarray(depth_est, np.float64)
                 - np.asarray(depth_gt, np.float64))
    x = np.clip(np.nan_to_num(err) / max(max_error, 1e-9), 0, 1)
    rgb = (_colormap(x, "jet") * 255).astype(np.uint8)
    if mask is not None:
        rgb[np.asarray(mask) <= 0.5] = 0
    return rgb


def _save_png(path: str, rgb: np.ndarray):
    from PIL import Image
    Image.fromarray(rgb).save(path)


def save_depth_png(path, depth, dmin=None, dmax=None, cmap="jet"):
    _save_png(path, depth_to_color(depth, dmin, dmax, cmap=cmap))


def convert_depth_png(pngfile: str, outdir: str, depth_scale: float = 1.0):
    """Colorize a 16-bit depth PNG (parity: convertPNG,
    the reference's visualize.py:47-61): reads the raw integer depth,
    rescales by depth_scale, writes <outdir>/<name>.png pseudo-colored."""
    import cv2
    raw = cv2.imread(pngfile, cv2.IMREAD_UNCHANGED)
    if raw is None:
        raise FileNotFoundError(pngfile)
    depth = raw.astype(np.float64) * depth_scale
    os.makedirs(outdir, exist_ok=True)
    out = os.path.join(outdir, os.path.basename(pngfile))
    _save_png(out, depth_to_color(depth))
    return out


def visualize_results_dir(results_dir: str, out_subdir: str = "viz",
                          conf_threshold: float | None = 0.9,
                          log_fn=print) -> int:
    """Walk a DepthRunner output tree (<scene>/depth_est/*.pfm +
    <scene>/confidence/*.pfm, infer/runner.py layout) and write
    pseudo-color PNGs for every depth/confidence map plus a photo-masked
    depth composite. Parity intent: visualization()
    (the reference's visualize.py:26-44) which batch-exports PFMs to PNGs.

    Returns the number of maps rendered."""
    from ..core.pfm import read_pfm
    count = 0
    for root, _dirs, files in os.walk(results_dir):
        pfms = [f for f in files if f.endswith(".pfm")]
        if not pfms:
            continue
        kind = os.path.basename(root)  # depth_est | confidence
        viz_dir = os.path.join(os.path.dirname(root), out_subdir)
        os.makedirs(viz_dir, exist_ok=True)
        for f in sorted(pfms):
            arr, _scale = read_pfm(os.path.join(root, f))
            arr = np.asarray(arr)
            name = os.path.splitext(f)[0]
            if kind == "confidence":
                rgb = confidence_to_color(arr, threshold=conf_threshold)
                _save_png(os.path.join(viz_dir, f"conf_{name}.png"), rgb)
            else:
                _save_png(os.path.join(viz_dir, f"depth_{name}.png"),
                          depth_to_color(arr))
                conf_path = os.path.join(os.path.dirname(root), "confidence",
                                         f)
                if conf_threshold is not None and os.path.exists(conf_path):
                    conf, _ = read_pfm(conf_path)
                    masked = np.where(np.asarray(conf) >= conf_threshold,
                                      arr, 0.0)
                    _save_png(os.path.join(viz_dir, f"masked_{name}.png"),
                              depth_to_color(masked))
            count += 1
    log_fn(f"visualize: rendered {count} maps under {results_dir}")
    return count
