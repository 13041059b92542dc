"""Train state and checkpoints; counterpart of damvsnet_tpu/train/state.py.

A checkpoint is one ``torch.save`` file holding the model's state_dict, the
optimizer's and the scheduler's, the step, the epoch and, for a mid-epoch
save, the data cursor (batches of the epoch already consumed). Per-epoch
saves are ``ckpt_{epoch:06d}.pt``, mid-epoch ones ``ckpt_step_{step:09d}.pt``
(reference parity for the first, train.py:130-137; the second is the JAX
package's preemption-safe extension). ``latest_checkpoint`` ranks both
kinds together by modification time.

Unlike the JAX package (ADVICE.md, round 5, ``train/state.py:131``):
  * the cursor travels inside the checkpoint file, which is written to a
    temporary name and renamed into place, so a checkpoint and its cursor
    appear together or not at all;
  * a ``Checkpointer`` runs at most one background save at a time (a new
    save first joins the previous one), so rotation never deletes a file
    another save is still writing.

Across ranks, rank 0 alone writes (the background step saves too), a
synchronous save ends at a barrier of every rank, so that no rank reads
before the file is in place, and every rank restores. The model saved is
the bare module, never its DDP wrapper, so a checkpoint written by N ranks
resumes on one and the reverse.

Trained weights from the JAX package come in through ``utils/weights.py``
(``.npz``); orbax checkpoints are not read.
"""
from __future__ import annotations

import os
import re
import threading
from dataclasses import dataclass

import torch
import torch.distributed as dist

_EPOCH = re.compile(r"ckpt_\d{6}\.pt")
_STEP = re.compile(r"ckpt_step_\d{9}\.pt")


@dataclass
class TrainState:
    """What a training run carries from step to step."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler | None = None
    step: int = 0
    epoch: int = 0


def _to_cpu(tree):
    """A host copy of a state_dict tree (the run goes on updating the
    device tensors in place while a background save writes)."""
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def checkpoint_path(logdir: str, state: TrainState, mid_epoch: bool) -> str:
    name = (f"ckpt_step_{state.step:09d}.pt" if mid_epoch
            else f"ckpt_{state.epoch:06d}.pt")
    return os.path.join(os.path.abspath(logdir), name)


class Checkpointer:
    """Writes checkpoints into one log directory, optionally on a
    background thread, one save at a time; across ranks, rank 0 writes.

    max_keep: keep at most this many checkpoints of each kind (the oldest
    go; utilsme/io_utils.py:157-191 semantics)."""

    def __init__(self, logdir: str, max_keep: int | None = None):
        self.logdir = os.path.abspath(logdir)
        self.max_keep = max_keep
        self.writes = not dist.is_initialized() or dist.get_rank() == 0
        self._pending: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, state: TrainState, cursor: int | None = None,
             background: bool = False) -> str:
        """Save ``state``; cursor=k marks a mid-epoch save after k batches
        of epoch ``state.epoch``. With background=True the payload is
        copied to the host here and written on a thread; ``wait()`` joins
        it. Returns the checkpoint's path. Across ranks, a synchronous save
        returns once every rank has reached it and the file is written."""
        self.wait()
        mid_epoch = cursor is not None
        path = checkpoint_path(self.logdir, state, mid_epoch)
        if not self.writes:
            if not background:
                dist.barrier()
            return path
        os.makedirs(self.logdir, exist_ok=True)
        payload = {
            "model": _to_cpu(state.model.state_dict()),
            "optimizer": _to_cpu(state.optimizer.state_dict()),
            "scheduler": (None if state.scheduler is None
                          else _to_cpu(state.scheduler.state_dict())),
            "step": int(state.step),
            "epoch": int(state.epoch),
            "cursor": int(cursor) if mid_epoch else 0,
        }
        if background:
            self._pending = threading.Thread(
                target=self._write_reporting, args=(path, payload, mid_epoch),
                daemon=True)
            self._pending.start()
        else:
            self._write(path, payload, mid_epoch)
            if dist.is_initialized():
                dist.barrier()
        return path

    def wait(self) -> None:
        """Join the background save in flight, if any; re-raise its error."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("background checkpoint save failed") from err

    def _write_reporting(self, path, payload, mid_epoch):
        try:
            self._write(path, payload, mid_epoch)
        except Exception as e:  # surfaced by the next wait()
            self._error = e

    def _write(self, path, payload, mid_epoch):
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)  # atomic: a reader never sees a partial file
        if self.max_keep is None:
            return
        pattern = _STEP if mid_epoch else _EPOCH
        names = sorted(d for d in os.listdir(self.logdir) if pattern.fullmatch(d))
        for stale in names[:-self.max_keep]:
            os.remove(os.path.join(self.logdir, stale))


def latest_checkpoint(logdir: str) -> str | None:
    """Newest checkpoint in logdir, epoch and step saves ranked together by
    modification time (a mid-epoch save is newer than the epoch save it
    follows)."""
    if not os.path.isdir(logdir):
        return None
    paths = [os.path.join(logdir, d) for d in os.listdir(logdir)
             if _EPOCH.fullmatch(d) or _STEP.fullmatch(d)]
    if not paths:
        return None
    return max(paths, key=lambda p: os.stat(p).st_mtime_ns)


def restore_checkpoint(path: str, state: TrainState, weights_only: bool = False):
    """Restore a checkpoint into ``state`` in place; returns (state,
    cursor), the cursor 0 for a per-epoch checkpoint. weights_only mirrors
    --loadckpt (the model only; step, epoch and the optimizer stay, and the
    cursor is 0)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(payload["model"])
    if not weights_only:
        state.optimizer.load_state_dict(payload["optimizer"])
        if state.scheduler is not None and payload["scheduler"] is not None:
            state.scheduler.load_state_dict(payload["scheduler"])
        state.step = payload["step"]
        state.epoch = payload["epoch"]
    return state, (0 if weights_only else payload["cursor"])
