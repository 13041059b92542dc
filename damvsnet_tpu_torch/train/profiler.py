"""Profiling hooks; counterpart of damvsnet_tpu/train/profiler.py (the
reference's vestigial torch profiler mode, train.py:344-372).

Usage:
    with trace_steps("/tmp/trace"):
        metrics = train_step(state, batch)

The port's layers open named spans (``span``): ``runner.*`` in
``DepthRunner``, ``cascade.*`` in ``CascadeMVSNet.forward``, ``loop.*`` in
the train step. Under a running profiler each is a ``record_function``
range on the trace's one timeline; with none running it costs the read of
one flag.
"""
from __future__ import annotations

import contextlib
import os

import torch
import torch.autograd.profiler as autograd_profiler
import torch.distributed as dist

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler.record_function`` range named ``name`` while a
    profiler runs; otherwise one shared no-op context (an idle
    ``record_function`` still pays for its enter and exit)."""
    if autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


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
