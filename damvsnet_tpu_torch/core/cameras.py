"""Per-stage camera matrices (copy of damvsnet_tpu/core/cameras.py:93-118).

Features are computed at 1/4, 1/2 and 1/1 of input resolution; per-stage
intrinsics scale rows 0..1 of K by 1/2/4 (reference:
datasets/dtu_yao.py:222-243).
"""
from __future__ import annotations

import numpy as np


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
