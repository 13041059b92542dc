"""Depth inference runner (counterpart of damvsnet_tpu/infer/runner.py).

``DepthRunner`` takes a batch of numpy arrays, runs the cascade under
``torch.inference_mode()`` and returns, as numpy, only what a depth-map
writer needs: final depth and confidence, and each lower stage's depth and
confidence.

The JAX runner's safety net — redoing a batch with the XLA sampler when the
banded TPU kernel reports dropped taps — has no counterpart: the port's
fused cost-volume kernel gathers every tap, so nothing can overflow, and
the ``sampler_overflow`` key is gone. Writing reference-format files
(``save_scene_depth``) belongs to the CLI slice.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device


class DepthRunner:
    def __init__(self, model, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    def __call__(self, batch: dict) -> dict:
        """batch: imgs [B, N, H, W, 3], proj_matrices {stage: [B, N, 2, 4, 4]},
        depth_values [B, D0] (other keys are ignored)."""
        with torch.inference_mode():
            out = self.model(
                self._tensor(batch["imgs"]),
                {k: self._tensor(v) for k, v in batch["proj_matrices"].items()},
                self._tensor(batch["depth_values"]))
            keep = {"depth": out["depth"],
                    "photometric_confidence": out["photometric_confidence"]}
            for i in range(1, len(self.model.ndepths)):
                s = f"stage{i}"
                keep[s] = {"depth": out[s]["depth"],
                           "photometric_confidence": out[s]["photometric_confidence"]}
            return _to_numpy(keep)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree.float().cpu().numpy()
