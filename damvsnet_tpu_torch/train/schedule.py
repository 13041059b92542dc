"""LR schedule and optimizer; counterpart of damvsnet_tpu/train/schedule.py.

Linear warmup (500 iterations unless the caller names another count) from
a factor of 1/3 to 1, then
lr *= gamma at each milestone iteration (reference WarmupMultiStepLR,
utils.py:208-252; recipe train.py:93-96). Milestones are given in epochs
with the "10,12,14:2" syntax (gamma = 1/2). The schedule is a
``LambdaLR`` of the optimizer's base lr; like optax's, its first value
(step 0) is the one the first update uses.
"""
from __future__ import annotations

import torch


def parse_lr_epochs(lrepochs: str):
    """'10,12,14:2' -> ([10, 12, 14], 0.5) (parity: train.py:93-95)."""
    milestones_str, gamma_str = lrepochs.split(":")
    milestones = [int(x) for x in milestones_str.split(",") if x]
    return milestones, 1.0 / float(gamma_str)


WARMUP_ITERS = 500
WARMUP_FACTOR = 1.0 / 3


def warmup_multistep_factor(milestones_iters, gamma: float, warmup_iters: int = WARMUP_ITERS,
                            warmup_factor: float = WARMUP_FACTOR):
    """step -> multiplier of the base lr."""
    milestones_iters = sorted(milestones_iters)

    def factor(step: int) -> float:
        alpha = min(max(step / max(warmup_iters, 1), 0.0), 1.0)
        warmup = warmup_factor * (1.0 - alpha) + alpha
        return warmup * gamma ** sum(step >= m for m in milestones_iters)

    return factor


def warmup_multistep_schedule(base_lr: float, milestones_iters, gamma: float,
                              warmup_iters: int = WARMUP_ITERS,
                              warmup_factor: float = WARMUP_FACTOR):
    """step -> lr, the JAX package's schedule function (the optimizer here
    takes the factor under ``LambdaLR``)."""
    factor = warmup_multistep_factor(milestones_iters, gamma, warmup_iters, warmup_factor)
    return lambda step: base_lr * factor(step)


def make_optimizer(params, base_lr: float, lrepochs: str, iters_per_epoch: int,
                   weight_decay: float = 0.0, warmup_iters: int = WARMUP_ITERS):
    """(optimizer, scheduler): Adam with the reference recipe (train.py:439:
    betas 0.9/0.999, eps 1e-8), or AdamW when weight_decay > 0 (decoupled
    decay scaled by the lr, as optax's adamw), under the warmup-multistep
    schedule warming up over ``warmup_iters`` steps. Call
    ``scheduler.step()`` after every ``optimizer.step()``."""
    milestones, gamma = parse_lr_epochs(lrepochs)
    cls = torch.optim.AdamW if weight_decay else torch.optim.Adam
    opt = cls(params, lr=base_lr, betas=(0.9, 0.999), eps=1e-8,
              weight_decay=weight_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, warmup_multistep_factor(
        [m * iters_per_epoch for m in milestones], gamma, warmup_iters))
    return opt, sched
