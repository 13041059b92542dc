"""The system under test, driven as its users drive it: the port's
``DepthRunner`` (serving), the step of ``make_train_step`` (training), and
that step on one process a card over the port's data group (training
across cards), built from a configuration file, fed from the traffic's
pool.

A session's set-up makes everything its window uses: the model and its
weights, the pool of inputs, and the warm-up that runs every shape the
window runs. ``window(seconds)`` then runs the cell's loop for that long
and returns what the host clock saw; ``unit()`` runs one more unit of the
same work, ``trace(units)`` that many under the profiler (``trace.py``);
``memory_peak_bytes()`` is the fullest card's peak, and ``close()`` ends
what the session started. ``GROUP`` names the configuration's group the
session runs ("serve" or "train"). Nothing here reads the reference.
"""
from __future__ import annotations

import sys
import time
import warnings

import numpy as np
import torch
from torch.profiler import record_function

from . import ranks, scenes, trace


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


class Session:
    """What every session shares: one process on one card."""

    def trace(self, units):
        """``units`` more units under the profiler, reduced (``trace.reduce``)."""
        return trace.reduce(trace.profile(self.unit, units), units)

    def memory_peak_bytes(self):
        return (torch.cuda.max_memory_allocated(self.device)
                if self.device.type == "cuda" else 0)

    def close(self):
        """Nothing outlives a one-process session."""


class Serve(Session):
    """One client in a closed loop, at the traffic's batch, calling the
    runner with numpy arrays and taking numpy depth maps back, cycling
    through the pool. ``keep`` answers of the window are kept for the
    check: a reservoir sample drawn from the seed."""

    GROUP = "serve"
    KEYS = {"kind", "height", "width", "nviews", "numdepth", "batch", "pool", "warmup",
            "check_sample", "trace_units"}  # of the traffic: every one is read

    def __init__(self, cell, seed, device, model=None):
        from damvsnet_tpu_torch.infer.runner import DepthRunner
        t = cell["traffic"]
        self.device = device
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


def _rows(batch, rows):
    """The batch's rows ``rows`` (numpy, nested as the loader nests it)."""
    if isinstance(batch, dict):
        return {k: _rows(v, rows) for k, v in batch.items()}
    return np.ascontiguousarray(batch[rows])


class Train(Session):
    """The training step, fed the pool's batches in turn. Set-up runs the
    first ``first_steps`` steps through the window's own call on
    distinct batches and keeps, for the check, their losses, the first
    gradient as Adam holds it after one step, and each leaf's change
    after the last of them.

    With a ``mesh`` whose data axis has more than one rank (``TrainRanks``
    and its other ranks), the pool holds the global batches, every rank
    renders the same pool from the seed, and each rank steps on its rows of
    each (the port's ``batch_rows``); the step is the port's across the
    data group, and ``first`` holds what rank 0's step sees: the global
    batch's loss, the averaged gradient, the first sample's depth."""

    GROUP = "train"
    KEYS = {"kind", "height", "width", "nviews", "numdepth", "batch", "pool", "first_steps",
            "iters_per_epoch", "trace_units"}

    def __init__(self, cell, seed, device, mesh=None):
        from damvsnet_tpu_torch.parallel import mesh as port_mesh
        from damvsnet_tpu_torch.train.loop import make_train_step
        from damvsnet_tpu_torch.train.schedule import make_optimizer
        from damvsnet_tpu_torch.train.state import TrainState
        cfg, t = cell["config"], cell["traffic"]
        tc = cfg["train"]
        self.device = device
        model = build_model(cfg, "train", device)
        p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
        b0 = {k: v.clone() for k, v in model.named_buffers() if "running" in k}
        opt, sched = make_optimizer(model.parameters(), **tc["optimizer"],
                                    iters_per_epoch=t["iters_per_epoch"])
        self.state = TrainState(model, opt, sched)
        self.step = make_train_step(**_args(tc["loss"]), device=device, mesh=mesh)
        self.pool = scenes.make_pool(seed, t["pool"], t["batch"], t["height"], t["width"],
                                     t["nviews"], t["numdepth"], device, with_gt=True)
        self.feed = self.pool
        if mesh is not None and mesh.data > 1:
            # looked up at call time: a fault of faults.py may stand in for it
            rows = port_mesh.batch_rows(t["batch"], mesh.data_rank, mesh.data)
            self.feed = [_rows(b, rows) for b in self.pool]
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
        batch = self.feed[self.n % len(self.feed)]
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


class TrainRanks(Train):
    """``Train`` on ``cell["chips"]`` ranks, one process a card, over the
    port's data group as its training CLI builds it under torchrun: this
    process is rank 0 on ``device`` and owns the clock; ranks 1.. are
    processes of their own (``ranks.py``) on the next cards, which run a
    step each time rank 0 does. The pool is the global batches; the check
    compares rank 0's first steps with the one-process reference on them,
    and ``first["replicas"]`` is the largest gap between rank 0's
    parameters and running statistics and any other rank's after them."""

    def __init__(self, cell, seed, device):
        self.ranks = ranks.Ranks(cell, seed, device)
        try:
            super().__init__(cell, seed, device, mesh=self.ranks.mesh)
            self.first["replicas"] = ranks.replica_gap(self.state.model)
            self.ranks.wait_ready()
        except BaseException:
            self.ranks.close()
            raise

    def unit(self):
        if self.ranks.ready:
            self.ranks.command("step")
        return super().unit()

    def window(self, seconds):
        self.ranks.extend(seconds)
        self.win = super().window(seconds)
        return self.win

    def trace(self, units):
        """Every rank profiles the same ``units`` steps; rank 0's reduction
        with the ranks' mean busy time and window, and each rank's seconds
        in NCCL's kernels, rank 0's first (``nccl_s``)."""
        self.ranks.command(f"trace {units}")
        t = trace.reduce(trace.profile(super().unit, units), units)
        others = self.ranks.replies("trace")
        t["ranks"] = [[t["busy_s"], t["window_s"]]] + [[o["busy_s"], o["window_s"]]
                                                       for o in others]
        t["nccl_s"] = [t["families"].get(ranks.NCCL, 0.0)] + [o["nccl_s"] for o in others]
        t["busy_s"] = float(np.mean([b for b, _ in t["ranks"]]))
        t["window_s"] = float(np.mean([w for _, w in t["ranks"]]))
        return t

    def memory_peak_bytes(self):
        """The fullest card's peak."""
        self.ranks.command("memory")
        return max([super().memory_peak_bytes()]
                   + [o["memory_peak_bytes"] for o in self.ranks.replies("memory")])

    def close(self):
        """Ends the ranks. After a window, says on standard error what each
        rank's window step cost: its time in the step's call, and what the
        step lines cost (rank 0's time writing them, the other ranks' wait
        for them); raises where a rank ran other steps than rank 0."""
        ends = self.ranks.close()
        if ends is None or not hasattr(self, "win"):
            return
        if any(o["units"] != self.n for o in ends):
            raise RuntimeError(f"the ranks ran {[self.n] + [o['units'] for o in ends]} steps")
        units = self.win["units"]
        calls = [self.win["dispatch_s"] / units] + [o["dispatch_s"] / o["steps"] for o in ends]
        waits = [o["wait_s"] / o["steps"] for o in ends]
        print(f"ranks: {len(ends) + 1} ran {self.n} steps each; a window step of "
              f"{1e3 * self.win['window_s'] / units!r} ms; in the step's call, rank by "
              f"rank, {[1e3 * c for c in calls]!r} ms; rank 0 writing its step lines "
              f"{1e3 * self.ranks.signal_s / units!r} ms, the other ranks waiting for "
              f"them {[1e3 * w for w in waits]!r} ms", file=sys.stderr)


SESSIONS = {"serve": Serve, "train": Train, "train_ranks": TrainRanks}
