"""Image and volume resizing (counterpart of damvsnet_tpu/ops/resize.py).

The JAX package reimplements torch's ``F.interpolate`` conventions; here
they are ``F.interpolate`` itself:
  * bilinear, align_corners=False  — stage handoff upsampling of depth/conf
  * bilinear, align_corners=True   — the CPC loss's source images
                                     (losses/crossview.py)
  * nearest (legacy torch)         — FPN top-down x2 upsampling
  * trilinear, align_corners=False — snapping depth hypotheses to stage res

The public functions keep the JAX package's layouts (NHWC images,
[B, D, H, W] volumes) so tests compare like with like. An NHWC tensor's
NCHW permutation is a free ``channels_last`` view, so no copy is made.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, out_hw, align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of [B, H, W, C] to [B, H2, W2, C], torch semantics."""
    if tuple(out_hw) == tuple(x.shape[1:3]):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(out_hw),
                      mode="bilinear", align_corners=align_corners)
    return y.permute(0, 2, 3, 1)


def resize_nearest(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Nearest resize of [B, H, W, C] (torch legacy 'nearest':
    src = floor(dst * in/out))."""
    if tuple(out_hw) == tuple(x.shape[1:3]):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(out_hw), mode="nearest")
    return y.permute(0, 2, 3, 1)


def resize_trilinear_depth(vol: torch.Tensor, out_dhw) -> torch.Tensor:
    """Trilinear resize of a depth-sample volume [B, D, H, W] -> [B, D2, H2, W2]."""
    if tuple(out_dhw) == tuple(vol.shape[1:]):
        return vol
    return F.interpolate(vol[:, None], size=tuple(out_dhw), mode="trilinear",
                         align_corners=False)[:, 0]
