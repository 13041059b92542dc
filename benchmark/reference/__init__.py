"""The benchmark's plain reference of DA-MVSNet: fp32 PyTorch, no kernel
of the program, nothing of the program imported. It reads the raw
checkpoint itself (``weights.load``) and takes the same input arrays as
the program.

A configuration names its reference: ``"reference": "<module>"`` in
``configs/<name>.json`` is ``benchmark/reference/<module>.py``; without
the key it is this package (``for_config``). A reference module gives:

  settings(cfg, kind)      what of a configuration it implements for
                           ``kind`` ("serve" or "train"), refusing anything
                           else (ValueError)
  load_weights(path, model_cfg, device)   (params, buffers) from the
                           configuration's raw checkpoint
  serve(params, buffers, model_cfg, batch, precision)   the serving
                           forward (eval-mode BatchNorm on the running
                           statistics)
  train_steps(params, buffers, train_cfg, batches, iters_per_epoch,
              precision)   the first steps of training from the
                           checkpoint, as the program's step takes them
  counted_pass(params, buffers, rcfg, batch, training)   the pass whose
                           FLOPs ``yardstick.counted_flops`` counts on the
                           meta device

A module of another architecture can subclass ``model.Cascade`` (its
``features``, ``costreg`` and the other layers are methods) and hand the
subclass to this package's ``serve``, ``train_steps`` and
``counted_pass`` as ``cascade``.
"""
from __future__ import annotations

import contextlib
import importlib
import sys

import torch

from . import train, weights
from .model import Cascade


def for_config(cfg):
    """The reference module that the configuration names, or this package.
    Raises ValueError for a name that is no module under
    ``benchmark/reference/``."""
    name = cfg.get("reference")
    if name is None:
        return sys.modules[__name__]
    if not isinstance(name, str) or not name.isidentifier():
        raise ValueError(f"reference {name!r} is not the name of a module under "
                         "benchmark/reference/")
    module = f"{__name__}.{name}"
    try:
        return importlib.import_module(module)
    except ModuleNotFoundError as e:
        if e.name != module:
            raise
        raise ValueError(f"no reference module {module} (benchmark/reference/{name}.py)") from e


def _triple(v):
    return isinstance(v, list) and len(v) == 3


# What the reference implements, key by key: a configuration's "model"
# group merged with its kind's holds exactly these keys, each with a value
# that passes. Anything else (FMT, GeoReg, RefineNet, the fused training
# route, another width) is refused before a run, never timed against a
# reference that would leave it out.
MODEL = {
    "arch_mode": lambda v: v == "fpn",
    "base_channels": lambda v: v == 8,
    "ndepths": lambda v: _triple(v) and all(isinstance(d, int) and d > 0 for d in v),
    "depth_intervals_ratio": _triple,  # stored by the program; no forward reads it
    "cr_base_chs": lambda v: v == [8, 8, 8],
    "agg_mode": lambda v: v in ("adaptive", "variance"),
    "use_geo_fusion": lambda v: isinstance(v, bool),
    "align_corners": lambda v: v is False,
    "use_fmt": lambda v: v is False,
    "share_cr": lambda v: v is False,
    "grad_method": lambda v: v == "detach",
    "reg_mode": lambda v: v == "costreg",
    "refine": lambda v: v is False,
    "clamp_samples": lambda v: isinstance(v, bool),
}
GROUPS = {
    "serve": {"model": MODEL},
    "train": {
        "model": {**MODEL, "fused_train": lambda v: v is False},
        "optimizer": {"base_lr": lambda v: isinstance(v, float) and v > 0,
                      "lrepochs": lambda v: isinstance(v, str) and ":" in v,
                      "weight_decay": lambda v: v == 0,  # Adam; AdamW is not here
                      "warmup_iters": lambda v: isinstance(v, int) and v > 0},
        "loss": {"dlossw": lambda v: _triple(v) and all(isinstance(w, float) for w in v),
                 "use_cpc": lambda v: v is True},
    },
}


def settings(cfg, kind):
    """The configuration's settings for ``kind`` ("serve" or "train") that
    the reference runs: {"model": the model group merged with the kind's,
    and for training "optimizer" and "loss"}. Raises ValueError where a
    group lacks a key the reference needs, holds one it does not know, or
    sets a value it does not implement."""
    if kind not in GROUPS:
        raise ValueError(f"kind {kind!r} is neither 'serve' nor 'train'")
    if set(cfg[kind]) != set(GROUPS[kind]):
        raise ValueError(f"the configuration's {kind!r} group holds {sorted(cfg[kind])}, "
                         f"the reference {__name__} reads {sorted(GROUPS[kind])}")
    both = set(cfg["model"]) & set(cfg[kind]["model"])
    if both:
        raise ValueError(f"{sorted(both)} set both in 'model' and in {kind!r}'s model")
    out = dict(cfg[kind], model={**cfg["model"], **cfg[kind]["model"]})
    for group, rules in GROUPS[kind].items():
        got = out[group]
        if set(got) != set(rules):
            raise ValueError(f"{kind} {group}: the reference {__name__} implements exactly "
                             f"{sorted(rules)}; missing {sorted(set(rules) - set(got))}, "
                             f"unknown {sorted(set(got) - set(rules))}")
        bad = {k: v for k, v in got.items() if not rules[k](v)}
        if bad:
            raise ValueError(f"{kind} {group}: values the reference {__name__} does not "
                             f"implement: {bad}")
    return out


def load_weights(path, model_cfg, device="cpu"):
    """(params, buffers) of the configuration's checkpoint, named as the
    reference DA-MVSNet names them (``weights.load``)."""
    return weights.load(path, model_cfg["agg_mode"] == "adaptive",
                        model_cfg["use_geo_fusion"], device)


@contextlib.contextmanager
def true_fp32():
    """TF32 off for matmuls and cuDNN convolutions inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _tensors(tree, device):
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    return torch.as_tensor(tree, dtype=torch.float32, device=device)


def serve(params, buffers, model_cfg, batch, precision="fp32", cascade=Cascade):
    """model_cfg: ``settings(...)["model"]``. batch: numpy imgs [B, N, H, W,
    3], proj_matrices {stage: [B, N, 2, 4, 4]}, depth_values [B, D0].
    Returns {stageK: {depth, photometric_confidence}} as fp32 tensors on the
    parameters' device."""
    device = next(iter(params.values())).device
    x = _tensors({k: batch[k] for k in ("imgs", "proj_matrices", "depth_values")}, device)
    with torch.no_grad(), true_fp32():
        out = cascade(params, buffers, model_cfg, training=False, precision=precision)(
            x["imgs"], x["proj_matrices"], x["depth_values"])
    return {f"stage{i}": {k: out[f"stage{i}"][k] for k in ("depth", "photometric_confidence")}
            for i in (1, 2, 3)}


def train_steps(params, buffers, train_cfg, batches, iters_per_epoch, precision="fp32",
                cascade=Cascade):
    """Adam steps from (params, buffers), one a batch (numpy, the
    training loader's layout); train_cfg: ``settings(cfg, "train")``. Each
    view's cost volume is checkpointed, so that the fp32 step fits where
    the program's bf16 step did. Returns dict(losses [float], grads {name:
    the first step's gradient}, params {name: after the last step},
    buffers {running statistics after the last step})."""
    device = next(iter(params.values())).device
    params = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    buffers = {k: v.clone() for k, v in buffers.items()}
    opt, o = train.Adam(params), train_cfg["optimizer"]
    losses, first_grads, depth = [], None, None
    with true_fp32():
        for step, batch in enumerate(batches):
            x = _tensors({k: batch[k] for k in ("imgs", "proj_matrices", "depth_values",
                                                 "depth", "mask")}, device)
            net = cascade(params, buffers, train_cfg["model"], training=True,
                          precision=precision, checkpoint_volumes=True)
            out = net(x["imgs"], x["proj_matrices"], x["depth_values"])
            total = train.loss(out, x, train_cfg["loss"]["dlossw"])
            net.recording = False  # checkpointed regions run again in backward
            names = list(params)
            grads = dict(zip(names, torch.autograd.grad(total, [params[k] for k in names],
                                                        allow_unused=True)))
            grads = {k: torch.zeros_like(params[k]) if g is None else g
                     for k, g in grads.items()}
            if first_grads is None:
                first_grads = {k: g.detach().clone() for k, g in grads.items()}
                depth = out["depth"][0].detach().clone()
            losses.append(float(total.detach()))
            del out, total
            opt.step(params, grads, train.learning_rate(
                step, iters_per_epoch, o["base_lr"], o["lrepochs"], o["warmup_iters"]))
            buffers = net.running_stats()
    return {"losses": losses, "grads": first_grads, "depth": depth,
            "params": {k: v.detach() for k, v in params.items()}, "buffers": buffers}


def counted_pass(params, buffers, rcfg, batch, training, cascade=Cascade):
    """The pass whose FLOPs are counted: the forward on ``batch`` (tensors)
    and, in training, the loss, returned for the backward; None in
    serving. rcfg: ``settings(cfg, kind)``."""
    out = cascade(params, buffers, rcfg["model"], training=training)(
        batch["imgs"], batch["proj_matrices"], batch["depth_values"])
    return train.loss(out, batch, rcfg["loss"]["dlossw"]) if training else None
