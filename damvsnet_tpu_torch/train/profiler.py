"""Profiling hooks; counterpart of damvsnet_tpu/train/profiler.py (the
reference's vestigial torch profiler mode, train.py:344-372, and its
per-iteration wall timing).

Usage:
    with trace_steps("/tmp/trace"):
        metrics = train_step(state, batch)

or the step timer:
    timer = StepTimer()
    with timer:
        ...
    print(timer.summary())
"""
from __future__ import annotations

import contextlib
import os
import time

import torch
import torch.distributed as dist


def trace_path(logdir: str) -> str:
    """The trace this rank writes: ``<logdir>/trace_rank<rank>.json``."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    return os.path.join(logdir, f"trace_rank{rank}.json")


@contextlib.contextmanager
def trace_steps(logdir: str):
    """torch.profiler around a block, the host's activity and, where a CUDA
    device is present, the card's; the block's trace is written as a
    Chrome trace to ``trace_path(logdir)``, one file per rank."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(trace_path(logdir))


class StepTimer:
    """Wall-clock per-step timing with running stats."""

    def __init__(self):
        self.times = []
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)
        return False

    def summary(self, skip_warmup: int = 1) -> dict:
        ts = self.times[skip_warmup:] or self.times
        if not ts:
            return {}
        return {
            "steps": len(ts),
            "mean_s": sum(ts) / len(ts),
            "min_s": min(ts),
            "max_s": max(ts),
        }
