"""Train and eval steps and the epoch-loop Trainer; counterpart of
damvsnet_tpu/train/loop.py (reference train.py:92-260).

A train step runs the cascade in training mode, the staged smooth-L1 +
12x CPC loss, the backward (K3 for the fused cost volume on the card), one
optimizer update and one scheduler step. Batches are dicts of numpy arrays
or tensors in the JAX package's layout (see ``data/common.py``); a step
moves them to its device. The steps run on CUDA unless built with
``device="cpu"``, and raise without a CUDA device.

Across ranks (a ``parallel.Mesh`` whose data axis has more than one rank)
each rank's batch is its rows of the global batch (``parallel.batch_rows``)
and the step is JAX's on the global batch: the model runs wrapped in DDP
(gradients averaged over the data group), BatchNorm takes its statistics
over the group (``nn.blocks.batch_stats_group``), the losses return each
rank's share of the global loss (``losses/``), which the step scales by the
world size so that DDP's average of the gradients is the global loss's, and
the metrics are averaged over the group before anything reads them. ``TrainState.model`` stays the bare module, so a
checkpoint carries no DDP prefix.

On a mesh with a space axis, a model built with its space group
(``CascadeMVSNet(slab_group=)``, the depth-slab axis of
``parallel/slab.py``): the ranks of a space group take the same rows and
compute the same loss; DDP, the loss scale and the metric mean are the
data group's (the ranks of this rank's space index). The parameters start
as those of the slab group's first rank; after the backward, the
gradients each rank holds one slab's share of
(``CascadeMVSNet.slab_share_parameters``) are summed over the slab group
in one all-reduce, so that every parameter's gradient is the one-process
gradient on the global batch. Only rank 0 writes summaries and
checkpoints; every rank can restore.

Scalars and image summaries go to a ``SummaryWriter`` (``train/logging.py``)
in the log directory, and lines to ``log_fn``.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Iterable

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from ..losses import cas_mvsnet_loss
from ..nn.blocks import batch_stats_group
from ..utils.device import resolve_device
from .logging import SummaryWriter
from .metrics import DictAverageMeter, abs_depth_error_metrics, thres_metrics
from .profiler import span
from .state import Checkpointer, TrainState

_MODEL_KEYS = ("imgs", "proj_matrices", "depth_values", "depth", "mask")


def batch_to_device(batch: dict, device) -> dict:
    """The model's and the loss's arrays of a batch as tensors on
    ``device`` (other keys, such as file names, are dropped)."""
    def move(x):
        if isinstance(x, dict):
            return {k: move(v) for k, v in x.items()}
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                               device=device)
    return {k: move(batch[k]) for k in _MODEL_KEYS if k in batch}


def _forward(model, batch):
    return model(batch["imgs"], batch["proj_matrices"], batch["depth_values"])


def _depth_metrics(depth_est, batch, thresholds=(2.0, 4.0, 8.0)):
    depth_gt = batch["depth"]["stage3"]
    mask = batch["mask"]["stage3"] > 0.5
    out = {"abs_depth_error": abs_depth_error_metrics(depth_est, depth_gt, mask)}
    for t in thresholds:
        out[f"thres{t:g}mm_error"] = thres_metrics(depth_est, depth_gt, mask, t)
    return out


def _data_group(mesh):
    """The mesh's data group, or None with one data rank."""
    return None if mesh is None or mesh.data == 1 else mesh.data_group


def _world(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _coalesced(tensors, collective) -> None:
    """``collective`` on each dtype's tensors flattened into one, the
    result copied back into them."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        collective(flat)
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))


def sync_slab_replicas(model) -> None:
    """Copy the slab group's first rank's parameters and buffers to every
    rank of the group (DDP broadcasts over the data group only)."""
    src = dist.get_global_rank(model.slab_group, 0)
    with torch.no_grad():
        _coalesced(list(model.parameters()) + list(model.buffers()),
                   lambda flat: dist.broadcast(flat, src=src, group=model.slab_group))


def sum_slab_shares(model) -> None:
    """Sum over the model's slab group the gradients each rank holds one
    slab's share of, in one all-reduce a dtype."""
    _coalesced([p.grad for p in model.slab_share_parameters() if p.grad is not None],
               lambda flat: dist.all_reduce(flat, group=model.slab_group))


def _group_mean(metrics: dict, group) -> dict:
    """Each scalar metric averaged over the group's ranks, one all-reduce
    (their batches are equal parts of the global batch)."""
    if group is None:
        return metrics
    vals = torch.stack([v.float().reshape(()) for v in metrics.values()])
    dist.all_reduce(vals, group=group)
    return dict(zip(metrics, (vals / dist.get_world_size(group)).unbind()))


def _first_sample_images(outputs, batch) -> dict:
    """The first sample's image summaries, the JAX step's ``_images``
    (damvsnet_tpu/train/loop.py:89-99)."""
    depth_est = outputs["depth"].detach()
    depth_gt = batch["depth"]["stage3"]
    maskf = (batch["mask"]["stage3"][0] > 0.5).to(depth_est.dtype)
    return {"depth_est": depth_est[0] * maskf, "depth_gt": depth_gt[0],
            "ref_img": batch["imgs"][0, 0], "mask": maskf,
            "errormap": (depth_est[0] - depth_gt[0]).abs() * maskf,
            "photometric_confidence": outputs["photometric_confidence"][0].detach()}


def make_train_step(dlossw=(0.5, 1.0, 2.0), use_cpc: bool = True,
                    grad_accum: int = 1, device=None, mesh=None) -> Callable:
    """Build the train step: (state, batch) -> metrics (0-dim tensors on
    the device; nothing waits for the device), plus ``_images``, the first
    sample's image summaries.

    grad_accum > 1: the batch's leading axis is split into that many
    microbatches, run in order (each updates the BN running statistics),
    whose gradients are averaged before the one update.

    mesh: with more than one data rank, ``batch`` is this rank's rows of the
    global batch and the step is the global batch's (see the module's
    docstring); DDP's gradient all-reduce runs with the last microbatch's
    backward only (``no_sync`` before). With a slab group, the slab shares
    are summed over it after the last backward.

    Under a profiler each microbatch opens ``loop.forward``, ``loop.loss``
    and ``loop.backward`` (the slab sum in the last one's), and the step
    ``loop.optimizer`` and ``loop.metrics``."""
    dev = resolve_device(device)
    group = _data_group(mesh)
    world = _world(group)
    wrapped = {}

    def ddp(model):
        # Every parameter gets a gradient in every microbatch but RefineNet's:
        # the loss reads no refined depth, as in JAX. Only that configuration
        # pays find_unused_parameters' graph search at every backward
        # (static_graph, the other way to skip them, fails under no_sync).
        # The synced statistics keep the buffers equal on every rank.
        if wrapped.get("module") is not model:
            wrapped["module"] = model
            wrapped["ddp"] = DistributedDataParallel(
                model, device_ids=[dev] if dev.type == "cuda" else None,
                process_group=group, broadcast_buffers=False,
                find_unused_parameters=model.refine)
        return wrapped["ddp"]

    def train_step(state: TrainState, batch: dict) -> dict:
        model = state.model
        model.train()
        if model.slab_group is not None and wrapped.get("synced") is not model:
            sync_slab_replicas(model)  # before DDP's own broadcast
            wrapped["synced"] = model
        net = model if group is None else ddp(model)
        batch = batch_to_device(batch, dev)
        if grad_accum > 1:
            micro = [_slice_batch(batch, i, grad_accum) for i in range(grad_accum)]
        else:
            micro = [batch]
        state.optimizer.zero_grad(set_to_none=True)
        total_sum, depths = 0.0, []
        for j, mb in enumerate(micro):
            last = j == len(micro) - 1
            sync = contextlib.nullcontext() if group is None or last else net.no_sync()
            with sync, batch_stats_group(group):
                with span("loop.forward"):
                    outputs = _forward(net, mb)
                with span("loop.loss"):
                    # world x this rank's share: DDP's gradient average and the
                    # metrics' mean over the ranks are then the global loss's
                    total, depth_loss, cpc = (world * x for x in cas_mvsnet_loss(
                        outputs, mb["imgs"], mb["proj_matrices"], mb["depth"], mb["mask"],
                        dlossw=dlossw, use_cpc=use_cpc, group=group))
                    total_sum = total_sum + total.detach()
                with span("loop.backward"):
                    (total / len(micro)).backward()
                    if last and model.slab_group is not None:
                        sum_slab_shares(model)
            depths.append(outputs["depth"].detach())
            if j == 0:
                first = ({k: outputs[k] for k in ("depth", "photometric_confidence")}, mb)
        with span("loop.optimizer"):
            state.optimizer.step()
            if state.scheduler is not None:
                state.scheduler.step()
        state.step += 1
        with span("loop.metrics"):
            metrics = {"loss": total_sum / len(micro), "depth_loss": depth_loss.detach(),
                       "cpc_loss": torch.as_tensor(cpc).detach()}
            metrics.update(_depth_metrics(torch.cat(depths), batch))
            metrics = _group_mean(metrics, group)
            metrics["_images"] = _first_sample_images(*first)
        return metrics

    return train_step


def _slice_batch(batch, i, n):
    def cut(x):
        if isinstance(x, dict):
            return {k: cut(v) for k, v in x.items()}
        size = x.shape[0] // n
        return x[i * size:(i + 1) * size]
    return cut(batch)


def make_eval_step(dlossw=(0.5, 1.0, 2.0), device=None, mesh=None) -> Callable:
    """Validation step (parity: test_sample_depth, train.py:263-342):
    (state, batch) -> (metrics, outputs); the depth loss and the banded
    threshold / abs-error metrics, no CPC, no gradient, the serving
    forward (eval-mode BN, the kernels). With more than one data rank the
    loss divides by the global mask count and the metrics are averaged
    over the data group."""
    dev = resolve_device(device)
    group = _data_group(mesh)
    world = _world(group)

    def eval_step(state: TrainState, batch: dict):
        model = state.model
        model.eval()
        batch = batch_to_device(batch, dev)
        with torch.no_grad():
            outputs = _forward(model, batch)
            _, depth_loss, _ = cas_mvsnet_loss(
                outputs, batch["imgs"], batch["proj_matrices"], batch["depth"],
                batch["mask"], dlossw=dlossw, use_cpc=False, group=group)
            metrics = {"depth_loss": world * depth_loss}
            metrics.update(_depth_metrics(outputs["depth"], batch,
                                          (2.0, 4.0, 8.0, 14.0, 20.0)))
            depth_gt = batch["depth"]["stage3"]
            mask = batch["mask"]["stage3"] > 0.5
            for lo, hi in ((0, 2.0), (2.0, 4.0), (4.0, 8.0), (8.0, 14.0),
                           (14.0, 20.0), (20.0, 1e5)):
                metrics[f"abserr_{lo}mm_{hi}mm"] = abs_depth_error_metrics(
                    outputs["depth"], depth_gt, mask, (lo, hi))
            metrics = _group_mean(metrics, group)
        return metrics, outputs

    return eval_step


class Trainer:
    """Epoch loop: train -> checkpoint -> eval (parity: train.py:98-172).

    save_freq > 0: a mid-epoch checkpoint with the data cursor every that
    many steps, written in the background (at most 2 kept).

    mesh: the ranks' mesh (``parallel.make_mesh``). Every rank steps; rank
    0 alone writes the event file (scalars ``train``, ``train_epoch`` and
    ``eval``, images at summary steps), the log lines and the checkpoints,
    and every rank waits at a barrier after each epoch's save."""

    def __init__(self, state: TrainState, logdir: str, dlossw=(0.5, 1.0, 2.0),
                 use_cpc: bool = True, summary_freq: int = 50, log_fn=print,
                 save_freq: int = 0, grad_accum: int = 1, device=None, mesh=None):
        self.state = state
        self.train_step = make_train_step(dlossw, use_cpc, grad_accum=grad_accum,
                                          device=device, mesh=mesh)
        self.eval_step = make_eval_step(dlossw, device=device, mesh=mesh)
        self.summary_freq = summary_freq
        self.save_freq = save_freq
        lead = not dist.is_initialized() or dist.get_rank() == 0
        self.log_fn = log_fn if lead else (lambda *_: None)
        self.writer = SummaryWriter(logdir) if lead else None
        self.epoch_saves = Checkpointer(logdir)
        self.step_saves = Checkpointer(logdir, max_keep=2)

    def train_epoch(self, batches: Iterable[dict], first_batch: int = 0) -> dict:
        """One epoch over ``batches``, which start at batch ``first_batch``
        of the epoch (the cursor of a mid-epoch checkpoint: the loader
        skips the batches before it by index, see ``DataLoader.iter_epoch``).
        Ends with the epoch checkpoint; returns the epoch's mean metrics."""
        meter = DictAverageMeter()
        for i, batch in enumerate(batches, start=first_batch):
            t0 = time.time()
            metrics = self.train_step(self.state, batch)
            images = metrics.pop("_images")
            if self.save_freq and (i + 1) % self.save_freq == 0:
                self.step_saves.save(self.state, cursor=i + 1, background=True)
            metrics = {k: float(v) for k, v in metrics.items()}
            meter.update(metrics)
            if (i + 1) % self.summary_freq == 0:
                if self.writer is not None:
                    self.writer.add_scalars("train", metrics, self.state.step)
                    self.writer.add_images("train", {k: v.float().cpu().numpy()
                                                     for k, v in images.items()},
                                           self.state.step)
                self.log_fn(f"epoch {self.state.epoch} iter {i} "
                            + " ".join(f"{k}={v:.4f}" for k, v in metrics.items())
                            + f" time={time.time() - t0:.3f}s")
        # the epoch checkpoint must end up newest (latest_checkpoint ranks
        # by mtime), so the mid-epoch save in flight finishes first
        self.step_saves.wait()
        self.state.epoch += 1
        self.epoch_saves.save(self.state)
        means = meter.mean()
        if self.writer is not None:
            self.writer.add_scalars("train_epoch", means, self.state.step)
        return means

    def eval_epoch(self, batches: Iterable[dict]) -> dict:
        meter = DictAverageMeter()
        for batch in batches:
            metrics, _ = self.eval_step(self.state, batch)
            meter.update(metrics)
        means = meter.mean()
        if self.writer is not None:
            self.writer.add_scalars("eval", means, self.state.step)
        self.log_fn("eval: " + " ".join(f"{k}={v:.4f}" for k, v in means.items()))
        return means

    def close(self) -> None:
        self.step_saves.wait()
        if self.writer is not None:
            self.writer.close()
