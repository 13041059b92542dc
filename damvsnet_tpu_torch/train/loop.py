"""Train and eval steps and the epoch-loop Trainer; counterpart of
damvsnet_tpu/train/loop.py (reference train.py:92-260).

A train step runs the cascade in training mode, the staged smooth-L1 +
12x CPC loss, the backward (K3 for the fused cost volume on the card), one
optimizer update and one scheduler step. Batches are dicts of numpy arrays
or tensors in the JAX package's layout (see ``data/common.py``); a step
moves them to its device. The steps run on CUDA unless built with
``device="cpu"``, and raise without a CUDA device.

Scalars go to ``log_fn``; image summaries and a SummaryWriter belong to
the tooling slice (ROADMAP Queue 1 item 14).
"""
from __future__ import annotations

import time
from typing import Callable, Iterable

import numpy as np
import torch

from ..losses import cas_mvsnet_loss
from ..utils.device import resolve_device
from .metrics import DictAverageMeter, abs_depth_error_metrics, thres_metrics
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


def make_train_step(dlossw=(0.5, 1.0, 2.0), use_cpc: bool = True,
                    grad_accum: int = 1, device=None) -> Callable:
    """Build the train step: (state, batch) -> metrics (0-dim tensors on
    the device; nothing waits for the device).

    grad_accum > 1: the batch's leading axis is split into that many
    microbatches, run in order (each updates the BN running statistics),
    whose gradients are averaged before the one update."""
    dev = resolve_device(device)

    def train_step(state: TrainState, batch: dict) -> dict:
        model = state.model
        model.train()
        batch = batch_to_device(batch, dev)
        if grad_accum > 1:
            micro = [_slice_batch(batch, i, grad_accum) for i in range(grad_accum)]
        else:
            micro = [batch]
        state.optimizer.zero_grad(set_to_none=True)
        total_sum, depths = 0.0, []
        for mb in micro:
            outputs = _forward(model, mb)
            total, depth_loss, cpc = cas_mvsnet_loss(
                outputs, mb["imgs"], mb["proj_matrices"], mb["depth"], mb["mask"],
                dlossw=dlossw, use_cpc=use_cpc)
            (total / len(micro)).backward()
            total_sum = total_sum + total.detach()
            depths.append(outputs["depth"].detach())
        state.optimizer.step()
        if state.scheduler is not None:
            state.scheduler.step()
        state.step += 1
        metrics = {"loss": total_sum / len(micro), "depth_loss": depth_loss.detach(),
                   "cpc_loss": torch.as_tensor(cpc).detach()}
        metrics.update(_depth_metrics(torch.cat(depths), batch))
        return metrics

    return train_step


def _slice_batch(batch, i, n):
    def cut(x):
        if isinstance(x, dict):
            return {k: cut(v) for k, v in x.items()}
        size = x.shape[0] // n
        return x[i * size:(i + 1) * size]
    return cut(batch)


def make_eval_step(dlossw=(0.5, 1.0, 2.0), device=None) -> Callable:
    """Validation step (parity: test_sample_depth, train.py:263-342):
    (state, batch) -> (metrics, outputs); the depth loss and the banded
    threshold / abs-error metrics, no CPC, no gradient, the serving
    forward (eval-mode BN, the kernels)."""
    dev = resolve_device(device)

    def eval_step(state: TrainState, batch: dict):
        model = state.model
        model.eval()
        batch = batch_to_device(batch, dev)
        with torch.no_grad():
            outputs = _forward(model, batch)
            _, depth_loss, _ = cas_mvsnet_loss(
                outputs, batch["imgs"], batch["proj_matrices"], batch["depth"],
                batch["mask"], dlossw=dlossw, use_cpc=False)
            metrics = {"depth_loss": depth_loss}
            metrics.update(_depth_metrics(outputs["depth"], batch,
                                          (2.0, 4.0, 8.0, 14.0, 20.0)))
            depth_gt = batch["depth"]["stage3"]
            mask = batch["mask"]["stage3"] > 0.5
            for lo, hi in ((0, 2.0), (2.0, 4.0), (4.0, 8.0), (8.0, 14.0),
                           (14.0, 20.0), (20.0, 1e5)):
                metrics[f"abserr_{lo}mm_{hi}mm"] = abs_depth_error_metrics(
                    outputs["depth"], depth_gt, mask, (lo, hi))
        return metrics, outputs

    return eval_step


class Trainer:
    """Epoch loop: train -> checkpoint -> eval (parity: train.py:98-172).

    save_freq > 0: a mid-epoch checkpoint with the data cursor every that
    many steps, written in the background (at most 2 kept)."""

    def __init__(self, state: TrainState, logdir: str, dlossw=(0.5, 1.0, 2.0),
                 use_cpc: bool = True, summary_freq: int = 50, log_fn=print,
                 save_freq: int = 0, grad_accum: int = 1, device=None):
        self.state = state
        self.train_step = make_train_step(dlossw, use_cpc, grad_accum=grad_accum,
                                          device=device)
        self.eval_step = make_eval_step(dlossw, device=device)
        self.summary_freq = summary_freq
        self.log_fn = log_fn
        self.save_freq = save_freq
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
            if self.save_freq and (i + 1) % self.save_freq == 0:
                self.step_saves.save(self.state, cursor=i + 1, background=True)
            metrics = {k: float(v) for k, v in metrics.items()}
            meter.update(metrics)
            if (i + 1) % self.summary_freq == 0:
                self.log_fn(f"epoch {self.state.epoch} iter {i} "
                            + " ".join(f"{k}={v:.4f}" for k, v in metrics.items())
                            + f" time={time.time() - t0:.3f}s")
        # the epoch checkpoint must end up newest (latest_checkpoint ranks
        # by mtime), so the mid-epoch save in flight finishes first
        self.step_saves.wait()
        self.state.epoch += 1
        self.epoch_saves.save(self.state)
        return meter.mean()

    def eval_epoch(self, batches: Iterable[dict]) -> dict:
        meter = DictAverageMeter()
        for batch in batches:
            metrics, _ = self.eval_step(self.state, batch)
            meter.update(metrics)
        means = meter.mean()
        self.log_fn("eval: " + " ".join(f"{k}={v:.4f}" for k, v in means.items()))
        return means
