"""The FMT configuration's checkpoint, made by the benchmark's plain
reference alone: nothing of the program is imported or run.

    python3 benchmark/fmt_weights.py --out weights/bench_fmt_ckpt.npz   (on a GPU)

Start: every tensor of ``weights/bench_ckpt.npz`` (the DTU configuration's
checkpoint, from the JAX package), and FMT and its pathway initialised as
the published modules initialise themselves (``seeded_fmt``, seed 19).
Training: 512 steps of the reference's own fp32 step
(``reference.train_steps`` through ``reference.fmt.FmtCascade``: the
staged smooth-L1 + CPC loss and its Adam, TF32 off) on synthetic scenes
of ``scenes.py`` at 128x160, N=5, batch 2, D0=48, ndepths 32,16,8; lr
5e-4 under the warm-up multistep
schedule (100 warm-up steps, x0.5 at 60 % and 80 % of the run). Output:
the flat layout of ``bench_ckpt.npz``, every tensor the reference reads
replaced by its trained value (``reference.weights.table`` and
``reference.fmt.table`` walked backwards), BatchNorm statistics included.
One JSON line reports the losses, the held-out depth error before and
after, the tensors left at their start and the file's sha256.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

START = "weights/bench_ckpt.npz"
CONFIG = "damvsnet_fmt_dtu"
HEIGHT, WIDTH, NVIEWS, BATCH, D0, NDEPTHS = 128, 160, 5, 2, 48, [32, 16, 8]
LR, WARMUP, STEPS_PER_EPOCH, STEPS, SEED = 5e-4, 100, 128, 512, 19
HELD_OUT = 4  # scenes of batch 1 from another seed


def seeded_fmt(seed, device):
    """{reference name: fp32 tensor} of FMT and its pathway as the published
    modules start: Dense weights Xavier-uniform (TransMVSNet's
    ``_reset_parameters``), Dense biases and the pathway's convolutions
    uniform in +-1/sqrt(fan_in) (torch's Linear and Conv2d defaults),
    LayerNorm weight 1 and bias 0."""
    import torch

    from benchmark.reference import fmt
    gen = torch.Generator().manual_seed(seed)
    shapes = {"query_projection": (32, 32), "key_projection": (32, 32),
              "value_projection": (32, 32), "out_projection": (32, 32),
              "linear1": (64, 32), "linear2": (32, 64), "dim_reduction_1": (16, 32, 1, 1),
              "dim_reduction_2": (8, 16, 1, 1), "smooth_1": (16, 16, 3, 3),
              "smooth_2": (8, 8, 3, 3)}

    def uniform(shape, bound):
        return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound

    out = {}
    for name, _, _ in fmt.table():
        module, kind = name.split(".")[-2:]
        if module.startswith("norm"):
            out[name] = torch.ones(32) if kind == "weight" else torch.zeros(32)
        elif kind == "bias":
            out[name] = uniform((shapes[module][0],), 1.0 / math.sqrt(shapes[module][1]))
        elif len(shapes[module]) == 2:
            fan_out, fan_in = shapes[module]
            out[name] = uniform(shapes[module], math.sqrt(6.0 / (fan_in + fan_out)))
        else:
            fan_in = math.prod(shapes[module][1:])
            out[name] = uniform(shapes[module], 1.0 / math.sqrt(fan_in))
    return {k: v.to(device) for k, v in out.items()}


def train_settings(cfg):
    """The reference's training settings: the configuration's model at the
    training depths, Adam and the staged loss."""
    model = {**cfg["model"], **cfg["serve"]["model"], "ndepths": NDEPTHS,
             "clamp_samples": False}
    epochs = STEPS // STEPS_PER_EPOCH
    milestones = f"{max(1, int(epochs * 0.6))},{max(2, int(epochs * 0.8))}:2"
    return {"model": model, "loss": {"dlossw": [0.5, 1.0, 2.0], "use_cpc": True},
            "optimizer": {"base_lr": LR, "lrepochs": milestones, "weight_decay": 0,
                          "warmup_iters": WARMUP}}


def batches(seed, count, batch, device):
    """``count`` batches of fresh scenes drawn from ``seed``, made as they
    are taken; the time so far goes to stderr every epoch."""
    from benchmark import scenes
    root, t0 = np.random.SeedSequence(seed), time.perf_counter()
    for step in range(count):
        if step and step % STEPS_PER_EPOCH == 0:
            print(f"step {step}: {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
        yield scenes.collate([scenes.make_sample(HEIGHT, WIDTH, NVIEWS, D0,
                                                 np.random.default_rng(s), device, True)
                              for s in root.spawn(batch)])


def held_out_error(params, buffers, model_cfg, seed, device):
    """Mean |stage-3 depth - truth| over the held-out scenes, as a share of
    each scene's depth sweep."""
    from benchmark.reference import fmt
    errs = []
    for b in batches(seed, HELD_OUT, 1, device):
        depth = fmt.serve(params, buffers, model_cfg, b)["stage3"]["depth"].cpu().numpy()
        sweep = float(b["depth_values"].max() - b["depth_values"].min())
        errs.append(float(np.abs(depth - b["depth"]["stage3"]).mean()) / sweep)
    return float(np.mean(errs))


def flat_checkpoint(start, params, buffers, model_cfg):
    """``start``'s arrays with every tensor the reference reads replaced:
    the tables walked from reference name to flat key."""
    from benchmark.reference import fmt, weights
    with np.load(start) as npz:
        flat = {k: npz[k] for k in npz.files}
    rows = (weights.table(model_cfg["agg_mode"] == "adaptive", model_cfg["use_geo_fusion"])
            + fmt.table())
    tensors = {**params, **buffers}
    for name, key, perm in rows:
        arr = tensors[name].detach().cpu().numpy().astype(np.float32)
        if perm is not None:
            arr = arr.transpose(np.argsort(perm))
        if key in flat and flat[key].shape != arr.shape:
            raise ValueError(f"{key}: {arr.shape} against the start's {flat[key].shape}")
        flat[key] = np.ascontiguousarray(arr)
    return flat


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    import torch

    from benchmark import cells, reference
    from benchmark.reference import fmt
    device = torch.device("cuda", 0)
    cfg = json.loads((cells.ROOT / "benchmark" / "configs" / f"{CONFIG}.json").read_text())
    tcfg = train_settings(cfg)
    params, buffers = reference.load_weights(START, tcfg["model"], device)
    params.update(seeded_fmt(SEED, device))
    before = held_out_error(params, buffers, tcfg["model"], SEED + 1, device)
    t0 = time.perf_counter()
    out = reference.train_steps(params, buffers, tcfg,
                                batches(SEED, STEPS, BATCH, device),
                                STEPS_PER_EPOCH, cascade=fmt.FmtCascade)
    seconds = time.perf_counter() - t0
    after = held_out_error(out["params"], out["buffers"], tcfg["model"], SEED + 1, device)
    left = sorted(k for k, v in {**out["params"], **out["buffers"]}.items()
                  if torch.equal(v, {**params, **buffers}[k]))
    np.savez_compressed(args.out, **flat_checkpoint(START, out["params"],
                                                    out["buffers"], tcfg["model"]))
    with open(args.out, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    losses = out["losses"]
    print(json.dumps({"out": args.out, "sha256": digest, "steps": STEPS,
                      "seed": SEED, "step_ms": round(1e3 * seconds / STEPS, 1),
                      "loss_first_10": float(np.mean(losses[:10])),
                      "loss_last_100": float(np.mean(losses[-100:])),
                      "held_out_error_before": before, "held_out_error_after": after,
                      "left_at_start": left,
                      "optimizer": tcfg["optimizer"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
