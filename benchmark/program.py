"""The system under test, driven as its users drive it: the port's
``DepthRunner`` (serving) and the step of ``make_train_step`` (training),
built from a configuration file, fed from the traffic's pool.

A session's set-up makes everything its window uses: the model and its
weights, the pool of inputs, and the warm-up that runs every shape the
window runs. ``window(seconds)`` then runs the cell's loop for that long
and returns what the host clock saw; ``unit()`` runs one more unit of the
same work, for the traced window. Nothing here reads the reference.
"""
from __future__ import annotations

import time
import warnings

import numpy as np
import torch
from torch.profiler import record_function

from . import scenes


def _args(group):
    """A configuration group as keyword arguments, its lists as tuples."""
    return {k: tuple(v) if isinstance(v, list) else v for k, v in group.items()}


def build_model(cfg, kind, device):
    """The port's CascadeMVSNet as the configuration runs it for ``kind``
    ("serve" or "train"): every key of its "model" group and of the kind's,
    in the configuration's compute dtype, with the configuration's
    weights."""
    from damvsnet_tpu_torch.model import CascadeMVSNet
    from damvsnet_tpu_torch.utils.weights import load_bench_weights
    model = CascadeMVSNet(**_args(cfg["model"]), **_args(cfg[kind]["model"]),
                          compute_dtype=getattr(torch, cfg["compute_dtype"]), device=device)
    with warnings.catch_warnings():
        # a variance model drops the checkpoint's weight-net keys, and says so
        warnings.simplefilter("ignore")
        load_bench_weights(model, cfg["weights"])
    return model


class Serve:
    """One client in a closed loop, at the traffic's batch, calling the
    runner with numpy arrays and taking numpy depth maps back, cycling
    through the pool. ``keep`` answers of the window are kept for the
    check: a reservoir sample drawn from the seed."""

    KEYS = {"kind", "height", "width", "nviews", "numdepth", "batch", "pool", "warmup",
            "check_sample", "trace_units"}  # of the traffic: every one is read

    def __init__(self, cell, seed, device, model=None):
        from damvsnet_tpu_torch.infer.runner import DepthRunner
        t = cell["traffic"]
        self.runner = DepthRunner(model or build_model(cell["config"], "serve", device), device)
        self.pool = scenes.make_pool(seed, t["pool"], t["batch"], t["height"], t["width"],
                                     t["nviews"], t["numdepth"], device, with_gt=False)
        self.rng = np.random.default_rng([seed % 2 ** 64, 1])
        self.keep = t["check_sample"]
        self.samples_per_unit = t["batch"]
        self.n = 0
        for i in range(t["warmup"]):  # each answer is on the host: the device is done
            self.runner(self.pool[i % len(self.pool)])

    def request(self):
        scene = self.n % len(self.pool)
        self.n += 1
        with record_function("bench.request"):
            return scene, self.runner(self.pool[scene])

    def window(self, seconds):
        """{"units", "window_s", "latencies_s", "dispatch_s", "kept":
        [(request index, scene, answer)]}."""
        lat, kept = [], []
        d0 = self.runner.time_dispatch
        t0 = end = time.perf_counter()
        i = 0
        while end - t0 < seconds:
            start = time.perf_counter()
            scene, out = self.request()
            end = time.perf_counter()
            lat.append(end - start)
            if i < self.keep:
                kept.append((i, scene, out))
            else:
                j = int(self.rng.integers(i + 1))
                if j < self.keep:
                    kept[j] = (i, scene, out)
            i += 1
        return {"units": i, "window_s": end - t0, "latencies_s": lat,
                "dispatch_s": self.runner.time_dispatch - d0, "kept": kept}

    def unit(self):
        self.request()


class Train:
    """The training step, fed the pool's batches in turn. Set-up runs the
    first ``first_steps`` steps through the window's own call on
    distinct batches and keeps, for the check, their losses, the first
    gradient as Adam holds it after one step, and each leaf's change
    after the last of them."""

    KEYS = {"kind", "height", "width", "nviews", "numdepth", "batch", "pool", "first_steps",
            "iters_per_epoch", "trace_units"}

    def __init__(self, cell, seed, device):
        from damvsnet_tpu_torch.train.loop import make_train_step
        from damvsnet_tpu_torch.train.schedule import make_optimizer
        from damvsnet_tpu_torch.train.state import TrainState
        cfg, t = cell["config"], cell["traffic"]
        tc = cfg["train"]
        model = build_model(cfg, "train", device)
        p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
        b0 = {k: v.clone() for k, v in model.named_buffers() if "running" in k}
        opt, sched = make_optimizer(model.parameters(), **tc["optimizer"],
                                    iters_per_epoch=t["iters_per_epoch"])
        self.state = TrainState(model, opt, sched)
        self.step = make_train_step(**_args(tc["loss"]), device=device)
        self.pool = scenes.make_pool(seed, t["pool"], t["batch"], t["height"], t["width"],
                                     t["nviews"], t["numdepth"], device, with_gt=True)
        self.samples_per_unit = t["batch"]
        self.n = 0
        beta1 = opt.defaults["betas"][0]
        losses, grads, depth = [], {}, None
        for i in range(t["first_steps"]):
            _, metrics, images = self.unit()
            losses.append(metrics["loss"])
            if i == 0:
                grads = {k: (opt.state[p]["exp_avg"] / (1 - beta1)).norm().item()
                         if p in opt.state else 0.0 for k, p in model.named_parameters()}
                depth = images["depth_est"].float().cpu().numpy()
        changes = {k: (v.detach() - p0[k]).norm().item() for k, v in model.named_parameters()}
        changes.update({k: (v - b0[k]).norm().item() for k, v in model.named_buffers()
                        if k in b0})
        self.first = {"losses": losses, "grad_norms": grads, "change_norms": changes,
                      "depth": depth}

    def unit(self):
        """One step on the next batch of the pool, its metrics read to the
        host as the training loop reads them. Returns (seconds in the step's
        call, metrics, the step's image summaries on the device: the first
        sample's final depth as ``depth_est``)."""
        batch = self.pool[self.n % len(self.pool)]
        self.n += 1
        with record_function("bench.step"):
            t0 = time.perf_counter()
            metrics = self.step(self.state, batch)
            call = time.perf_counter() - t0
        with record_function("bench.read_metrics"):
            images = metrics.pop("_images")
            return call, {k: float(v) for k, v in metrics.items()}, images

    def window(self, seconds):
        """{"units", "window_s", "dispatch_s", "failed"}."""
        t0 = end = time.perf_counter()
        n = failed = 0
        dispatch = 0.0
        while end - t0 < seconds:
            call, metrics, _ = self.unit()
            end = time.perf_counter()
            dispatch += call
            failed += not np.isfinite(metrics["loss"])
            n += 1
        return {"units": n, "window_s": end - t0, "dispatch_s": dispatch, "failed": failed}


SESSIONS = {"serve": Serve, "train": Train}
