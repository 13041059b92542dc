"""Depth inference runner and depth-file writer (counterpart of
damvsnet_tpu/infer/runner.py).

``DepthRunner`` takes a batch of numpy arrays, runs the cascade under
``torch.inference_mode()`` and returns, as numpy, only what a depth-map
writer needs: final depth and confidence, and each lower stage's depth and
confidence. ``save_scene_depth`` runs it over a dataset and writes the
reference's files.

The JAX runner's safety net — redoing a batch with the XLA sampler when the
banded TPU kernel reports dropped taps — has no counterpart: the port's
fused cost-volume kernel gathers every tap, so nothing can overflow, and
the ``sampler_overflow`` key is gone.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..core import imageio
from ..core.cameras import write_cam_file
from ..core.pfm import write_pfm
from ..data.common import DataLoader
from ..train.profiler import span
from ..utils.device import resolve_device


STAGING_ALIGN = 256
"""Each input's byte offset in the staging buffers is a multiple of this."""


def staging_layout(tensors):
    """(byte offset of each tensor in one buffer, bytes the buffer needs):
    the tensors one after another, each starting at a multiple of
    ``STAGING_ALIGN``."""
    offsets, end = [], 0
    for t in tensors:
        offsets.append(end)
        end += -(-t.numel() * t.element_size() // STAGING_ALIGN) * STAGING_ALIGN
    return offsets, end


def staging_views(buf, tensors, offsets):
    """Views of the uint8 buffer ``buf``, one per tensor at its offset, each
    with that tensor's dtype and shape."""
    return [buf[o:o + t.numel() * t.element_size()].view(t.dtype).view(t.shape)
            for t, o in zip(tensors, offsets)]


class DepthRunner:
    """``time_dispatch`` sums the forward calls (the inputs' upload, the
    host's work and the launches it enqueues), ``time_upload`` the upload
    alone (a part of ``time_dispatch``), ``time_fetch`` the copies of the
    outputs to the host (which wait for the device): the split that tells
    host time from device time. Under a profiler a call opens the spans
    ``runner.upload``, ``runner.forward`` and ``runner.fetch``.

    On a CUDA device a request's inputs go up through two staging buffers
    the runner keeps: pinned host memory, which the host fills, and a
    device buffer of the same size, which one asynchronous copy fills and
    whose views (``staging_views``) the model reads. There ``time_upload``
    and ``runner.upload`` cover the fill and the copy's enqueue, not the
    copy, which runs on the device while the host enqueues the forward. The
    buffers only grow, when a request needs more bytes than they hold, and
    are held for the runner's life. ``staged_uploads`` counts the requests
    uploaded so, ``staging_grows`` the buffers' allocations. On the CPU the
    inputs are copied as tensors of their own, and both counters stay 0."""

    def __init__(self, model, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.time_dispatch = 0.0
        self.time_upload = 0.0
        self.time_fetch = 0.0
        self.staged_uploads = 0
        self.staging_grows = 0
        self._pinned = self._staged = self._copied = None

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    def _upload(self, arrays) -> list:
        """The arrays on the device, with the dtypes and shapes
        ``torch.as_tensor`` gives them."""
        if self.device.type != "cuda":
            return [self._tensor(a) for a in arrays]
        host = [torch.from_numpy(np.asarray(a, order="C")) for a in arrays]
        offsets, nbytes = staging_layout(host)
        if self._copied is not None:
            self._copied.synchronize()  # the last copy has read the pinned bytes
        if self._pinned is None or self._pinned.numel() < nbytes:
            self._pinned = self._staged = None  # freed before the larger pair
            self._pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            self._staged = torch.empty(nbytes, dtype=torch.uint8, device=self.device)
            self.staging_grows += 1
        for slot, t in zip(staging_views(self._pinned, host, offsets), host):
            slot.copy_(t)
        self._staged[:nbytes].copy_(self._pinned[:nbytes], non_blocking=True)
        self._copied = torch.cuda.Event()
        self._copied.record(torch.cuda.current_stream(self.device))
        self.staged_uploads += 1
        return staging_views(self._staged, host, offsets)

    def __call__(self, batch: dict) -> dict:
        """batch: imgs [B, N, H, W, 3], proj_matrices {stage: [B, N, 2, 4, 4]},
        depth_values [B, D0] (other keys are ignored)."""
        with torch.inference_mode():
            t0 = time.perf_counter()
            with span("runner.upload"):
                stages = list(batch["proj_matrices"])
                imgs, *projs, depth_values = self._upload(
                    [batch["imgs"], *batch["proj_matrices"].values(), batch["depth_values"]])
                proj = dict(zip(stages, projs))
            t1 = time.perf_counter()
            with span("runner.forward"):
                out = self.model(imgs, proj, depth_values)
                keep = {"depth": out["depth"],
                        "photometric_confidence": out["photometric_confidence"]}
                for i in range(1, len(self.model.ndepths)):
                    s = f"stage{i}"
                    keep[s] = {"depth": out[s]["depth"],
                               "photometric_confidence": out[s]["photometric_confidence"]}
            t2 = time.perf_counter()
            with span("runner.fetch"):
                keep = _to_numpy(keep)
            self.time_upload += t1 - t0
            self.time_dispatch += t2 - t0
            self.time_fetch += time.perf_counter() - t2
            return keep


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree.float().cpu().numpy()


def upsample_nearest(img: np.ndarray, out_hw) -> np.ndarray:
    """Nearest-neighbour resize of [h, w] to ``out_hw`` by cv2's
    INTER_NEAREST index rule, src = floor(dst * (1 / (dst_size / src_size)))
    clipped to the last row or column: the same pixels as
    ``cv2.resize(img, (W, H), interpolation=cv2.INTER_NEAREST)`` at any
    ratio."""
    def index(n_out, n_in):
        inv_scale = 1.0 / (n_out / n_in)
        return np.minimum(np.floor(np.arange(n_out) * inv_scale).astype(np.int64), n_in - 1)

    return img[index(out_hw[0], img.shape[0])[:, None], index(out_hw[1], img.shape[1])]


def save_scene_depth(runner: DepthRunner, dataset, outdir: str,
                     batch_size: int = 1, log_fn=print):
    """Run depth inference over a dataset and write, per reference view,
    under outdir/scene/: depth_est/{v}.pfm (and _stage1/_stage2),
    confidence/{v}.pfm (the lower stages' confidences nearest-upsampled to
    full resolution), cams/{v}_cam.txt and images/{v}.jpg (the reference's
    test_uni.py:207-290, damvsnet_tpu/infer/runner.py:105-183).

    Returns (count, total_time, batch_times). batch_times[0] includes the
    first call's warm-up (kernel builds, cuDNN's setup), so the steady
    rate is ``sum(batch_times[1:]) / (count - n0)`` with n0 the measured
    size of batch 0 (partial batches are kept).
    """
    loader = DataLoader(dataset, batch_size=batch_size, shuffle=False,
                        drop_last=False, num_workers=2)
    num_stage = len(runner.model.ndepths)
    batch_times = []
    count = 0
    first_batch_n = 0
    write_time = 0.0
    for batch in loader.iter_epoch(0):
        t0 = time.time()
        outputs = runner({k: v for k, v in batch.items() if k != "filename"})
        batch_times.append(time.time() - t0)
        t_w = time.time()
        if not count:
            first_batch_n = batch["imgs"].shape[0]
        count += batch["imgs"].shape[0]
        cams = batch["proj_matrices"][f"stage{num_stage}"]
        for i, filename in enumerate(batch["filename"]):
            depth_est = outputs["depth"][i]
            conf = outputs["photometric_confidence"][i]
            h, w = conf.shape

            paths = {
                "depth": filename.format("depth_est", ".pfm"),
                "conf": filename.format("confidence", ".pfm"),
                "cam": filename.format("cams", "_cam.txt"),
                "img": filename.format("images", ".jpg"),
            }
            stage_outs = {}
            for s in range(1, num_stage):
                paths[f"depth{s}"] = filename.format("depth_est", f"_stage{s}.pfm")
                paths[f"conf{s}"] = filename.format("confidence", f"_stage{s}.pfm")
                stage_outs[s] = (
                    outputs[f"stage{s}"]["depth"][i],
                    upsample_nearest(outputs[f"stage{s}"]["photometric_confidence"][i],
                                     (h, w)))
            for p in paths.values():
                os.makedirs(os.path.join(outdir, os.path.dirname(p)), exist_ok=True)
            write_pfm(os.path.join(outdir, paths["depth"]), depth_est.astype(np.float32))
            write_pfm(os.path.join(outdir, paths["conf"]), conf.astype(np.float32))
            for s, (dep_s, conf_s) in stage_outs.items():
                write_pfm(os.path.join(outdir, paths[f"depth{s}"]), dep_s.astype(np.float32))
                write_pfm(os.path.join(outdir, paths[f"conf{s}"]), conf_s.astype(np.float32))
            cam = cams[i, 0]
            write_cam_file(os.path.join(outdir, paths["cam"]),
                           cam[1, :3, :3], cam[0], 0.0, 0.0)
            img = np.clip(batch["imgs"][i, 0] * 255, 0, 255).astype(np.uint8)
            imageio.write_rgb(os.path.join(outdir, paths["img"]), img)
        write_time += time.time() - t_w
    total_time = sum(batch_times)
    if count:
        steady = (sum(batch_times[1:]) / max(1, count - first_batch_n)
                  if len(batch_times) > 1 else total_time / count)
        log_fn(f"inference: {count} views, {steady:.3f}s/view steady "
               f"(first batch {batch_times[0]:.1f}s incl. warm-up; "
               f"dispatch {runner.time_dispatch:.1f}s "
               f"(upload {runner.time_upload:.1f}s), "
               f"fetch {runner.time_fetch:.1f}s, "
               f"write {write_time:.1f}s total)")
    return count, total_time, batch_times
