"""Collation, a host-side loader with background prefetch, and BlendedMVS's
training augmentations; counterpart of damvsnet_tpu/data/common.py (the
augmentations are copies, ``motion_blur`` imports cv2 where it runs).

Samples are dicts of numpy arrays in NHWC; ``collate`` stacks a leading
batch axis. The loader's order is a function of (seed, epoch) only, so a
run resumed from a mid-epoch checkpoint sees the same batches as the run
it replaces: the caller names the epoch (``iter_epoch``) rather than
counting calls, and batches before the cursor are skipped by index,
before any sample is loaded. Across ranks each rank loads only its rows of
every global batch (``parallel/mesh.py::batch_rows``); the order, the
length and the cursor are the global batches'.
"""
from __future__ import annotations

import concurrent.futures as cf
import queue
import threading
from typing import Iterator, Sequence

import numpy as np

from ..parallel.mesh import batch_rows


def collate(samples: Sequence[dict]) -> dict:
    """Stack a list of sample dicts into one batch dict (recurses dicts)."""
    out = {}
    for k, v in samples[0].items():
        if isinstance(v, dict):
            out[k] = collate([s[k] for s in samples])
        elif isinstance(v, np.ndarray):
            out[k] = np.stack([s[k] for s in samples])
        elif isinstance(v, (int, float, np.floating, np.integer)):
            out[k] = np.asarray([s[k] for s in samples])
        else:  # strings (filenames) etc.
            out[k] = [s[k] for s in samples]
    return out


class DataLoader:
    """Shuffling, batching and threaded prefetch of up to ``PREFETCH``
    batches. ``drop_last`` (training: fixed shapes) drops the last partial
    batch; the depth writer keeps it.

    rank, world, grad_accum: ``batch_size`` is the global batch, of which
    this data rank yields its rows (``batch_rows``: its part of each of the
    step's ``grad_accum`` microbatches); the batches must be whole."""

    PREFETCH = 2

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 seed: int = 0, num_workers: int = 4, drop_last: bool = True,
                 rank: int = 0, world: int = 1, grad_accum: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.rows = None
        if world > 1 or grad_accum > 1:
            if not drop_last:
                raise ValueError("a loader split over ranks or microbatches drops the "
                                 "last partial batch")
            self.rows = batch_rows(batch_size, rank, world, grad_accum)

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _indices(self, epoch: int):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(idx)
        return idx

    def iter_epoch(self, epoch: int, skip: int = 0) -> Iterator[dict]:
        """The batches of ``epoch`` from batch ``skip`` on."""
        idx = self._indices(epoch)
        batches = [idx[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(skip, len(self))]
        if self.rows is not None:
            batches = [b[self.rows] for b in batches]
        if self.num_workers <= 0:
            for b in batches:
                yield collate([self.dataset[int(i)] for i in b])
            return

        q: queue.Queue = queue.Queue(maxsize=self.PREFETCH)
        stop = threading.Event()

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with cf.ThreadPoolExecutor(self.num_workers) as pool:
                    for b in batches:
                        samples = list(pool.map(self.dataset.__getitem__, b.tolist()))
                        if not put(collate(samples)):
                            return
            except Exception as e:  # handed to the consumer, raised there
                put(e)
                return
            put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            t.join()


def color_jitter(img: np.ndarray, rs: np.random.Generator,
                 brightness: float = 0.25, contrast=(0.3, 1.5)) -> np.ndarray:
    """torchvision ColorJitter(brightness=0.25, contrast=(0.3, 1.5)) on a
    float [0, 255] HWC image (parity: datasets/blendedmvs.py:52)."""
    ops = []
    b = rs.uniform(max(0.0, 1 - brightness), 1 + brightness)
    ops.append(lambda x: np.clip(x * b, 0, 255))
    c = rs.uniform(*contrast)
    ops.append(lambda x: np.clip(
        c * x + (1 - c) * (0.299 * x[..., 0] + 0.587 * x[..., 1]
                           + 0.114 * x[..., 2]).mean(), 0, 255))
    order = rs.permutation(len(ops))
    for i in order:
        img = ops[i](img)
    return img


def motion_blur(img: np.ndarray, rs: np.random.Generator,
                max_kernel_size: int = 3) -> np.ndarray:
    """Random directional Gaussian-weighted blur
    (parity: datasets/blendedmvs.py:17-37)."""
    import cv2
    mode = rs.choice(["h", "v", "diag_down", "diag_up"])
    ksize = int(rs.integers(0, (max_kernel_size + 1) // 2)) * 2 + 1
    center = (ksize - 1) // 2
    kernel = np.zeros((ksize, ksize))
    if mode == "h":
        kernel[center, :] = 1.0
    elif mode == "v":
        kernel[:, center] = 1.0
    elif mode == "diag_down":
        kernel = np.eye(ksize)
    else:
        kernel = np.flip(np.eye(ksize), 0)
    var = ksize * ksize / 16.0
    grid = np.repeat(np.arange(ksize)[:, None], ksize, axis=-1)
    gaussian = np.exp(-(np.square(grid - center) + np.square(grid.T - center))
                      / (2.0 * var))
    kernel = kernel * gaussian
    kernel /= kernel.sum()
    return cv2.filter2D(img, -1, kernel)
