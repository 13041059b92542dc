"""Where the PyTorch/CUDA port spends device time, serving or training.

    python3 scripts/profile_torch_cascade.py [--train [--nonfused]] [--agg-mode variance]
                                          [--variant fmt|georeg]
                                          [--cudnn-benchmark] [--trace PATH]
                                          (repository root, one GPU)

Serving (the default): the cascade (1152x864, N=5, ndepths 64/32/8, bf16,
the trained weights of weights/bench_ckpt.npz, the synthetic scene of
chip_smoke.py) through DepthRunner, one warm-up request, then REPEATS
requests under torch.profiler. ``--agg-mode variance`` serves the
variance-aggregation cascade instead (K4's variance entry, one launch a
stage for all views; the same weights less the weight nets).

``--train``: the training step of chip_smoke.py phase 7 (512x640, B=4,
N=5, D0=192, ndepths 64/32/8, bf16, the trained weights, Adam under the
warmup schedule, CPC on) through make_train_step, two warm-up steps on
their own batches, then REPEATS steps under torch.profiler. ``--train
--nonfused``: the same step as the JAX CLI's default builds it (phase 10:
``fused_train=False``, unclamped hypotheses, the plain warp under autograd,
the weight nets with batch statistics); ``--train --agg-mode variance``:
the variance training step (phase 11, always non-fused).

``--variant fmt``: serving with the FMT pathway (chip_smoke.py phase 14;
the trained weights and a seeded pathway), then the pathway alone, on the
request's features; with ``--train`` the phase-15 step (fused, FMT, the
undetached handoff). ``--variant georeg``: serving with GeoRegNet2d,
RefineNet and the U-Net FeatureNet, those seeded (phase 16).

Prints device time per kernel family, the top kernels and the slowest
convolutions with their input shapes, the device's busy time (the union
of its activities' intervals) and idle share of the profiled wall time,
the port's spans (``benchmark/spans.py``: device ms, launches, idle ms and
calls a request or step, each span's children included), and one JSON
line. ``--trace PATH`` writes the Chrome trace there, the spans in it.

``--cudnn-benchmark`` is a diagnostic, not a serving setting: it lets cuDNN
time its algorithms per shape during the warm-up
(``torch.backends.cudnn.benchmark``) to show what the algorithm choice is
worth. The port itself leaves it off.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import spans  # noqa: E402
from benchmark.yardstick import family, union_length  # noqa: E402

REPEATS = 3


# --variant: the CascadeMVSNet fields, and the modules that start from the
# seeded init (torch.manual_seed(3)); the rest loads weights/bench_ckpt.npz
VARIANTS = {None: ({}, ()),
            "fmt": ({"use_fmt": True}, ("FMT_with_pathway",)),
            "georeg": ({"reg_mode": "georeg", "refine": True, "arch_mode": "unet"},
                       ("feature", "cost_regularization", "refine_network"))}


def serving_request(agg_mode="adaptive", variant=None):
    """Warm DepthRunner up on the serving request; return the request and
    {name: a part of it to profile alone}."""
    import torch
    from damvsnet_tpu_torch.data.synthetic import make_synthetic_sample
    from damvsnet_tpu_torch.infer import DepthRunner
    from damvsnet_tpu_torch.model import CascadeMVSNet
    from damvsnet_tpu_torch.utils.weights import load_bench_weights

    sample = make_synthetic_sample(height=864, width=1152, nviews=5, ndepths=192,
                                   with_gt=False, seed=3)
    batch = {"imgs": sample["imgs"][None],
             "proj_matrices": {k: v[None] for k, v in sample["proj_matrices"].items()},
             "depth_values": sample["depth_values"][None]}
    config, seeded = VARIANTS[variant]
    torch.manual_seed(3)
    model = CascadeMVSNet(ndepths=(64, 32, 8), compute_dtype=torch.bfloat16,
                          agg_mode=agg_mode, **config)
    load_bench_weights(model, "weights/bench_ckpt.npz", seeded)
    runner = DepthRunner(model)
    runner(batch)
    parts = {}
    if variant == "fmt":
        with torch.inference_mode():
            feats = model._view_features(runner._tensor(batch["imgs"]))

        def pathway():
            with torch.inference_mode():
                model.FMT_with_pathway(feats, torch.bfloat16)
        parts["FMT pathway"] = pathway
    return (lambda: runner(batch)), parts


def training_step(fused=True, agg_mode="adaptive", variant=None):
    """Warm the training step up (two steps); return one more step, on a
    batch of its own."""
    import torch
    from damvsnet_tpu_torch.data.common import collate
    from damvsnet_tpu_torch.data.synthetic import make_synthetic_sample
    from damvsnet_tpu_torch.model import CascadeMVSNet
    from damvsnet_tpu_torch.train.loop import make_train_step
    from damvsnet_tpu_torch.train.schedule import make_optimizer
    from damvsnet_tpu_torch.train.state import TrainState
    from damvsnet_tpu_torch.utils.weights import load_bench_weights

    config, seeded = VARIANTS[variant]
    if variant == "fmt":
        config = dict(config, grad_method="undetach")
    torch.manual_seed(3)
    model = CascadeMVSNet(ndepths=(64, 32, 8), compute_dtype=torch.bfloat16, agg_mode=agg_mode,
                          fused_train=fused, clamp_samples=fused, **config)
    load_bench_weights(model, "weights/bench_ckpt.npz", seeded)
    optimizer, scheduler = make_optimizer(model.parameters(), 1e-3, "10,12,14:2",
                                          iters_per_epoch=1000)
    state = TrainState(model, optimizer, scheduler)
    step = make_train_step()
    batches = [collate([make_synthetic_sample(height=512, width=640, nviews=5,
                                              ndepths=192, seed=4 * i + k)
                        for k in range(4)]) for i in range(3)]
    for batch in batches[:2]:
        step(state, batch)
    torch.cuda.synchronize()
    return (lambda: step(state, batches[2])), {}


def device_activities(prof):
    """({kernel name: [device ms, count]}, busy ms) of a profile's device
    activities (kernels, memcpys, memsets; not the device-side copies of
    the port's spans, which are annotations): operator rows of
    key_averages() repeat their kernels' time. Busy is the union of their
    intervals, so activities that overlap on streams count once."""
    from torch.autograd import DeviceType
    per_kernel = defaultdict(lambda: [0.0, 0])
    intervals = []
    for evt in prof.events():
        if (evt.device_type != DeviceType.CUDA or evt.is_user_annotation
                or evt.name.startswith("Activity Buffer")):
            continue
        per_kernel[evt.name][0] += evt.time_range.elapsed_us() / 1e3
        per_kernel[evt.name][1] += 1
        intervals.append((evt.time_range.start, evt.time_range.end))
    return per_kernel, union_length(intervals) / 1e3


def print_families(per_kernel, unit, top):
    per_family = defaultdict(float)
    for name, (ms, _) in per_kernel.items():
        per_family[family(name)] += ms
    busy_ms = sum(ms for ms, _ in per_kernel.values())
    for fam, ms in sorted(per_family.items(), key=lambda kv: -kv[1]):
        print(f"  {fam:30s} {ms / REPEATS:9.3f} ms/{unit}  {ms / busy_ms:6.1%}")
    print(f"top device activities (ms per {unit}, count per {unit}):")
    for name, (ms, n) in sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"  {ms / REPEATS:9.3f}  {n / REPEATS:6.1f}  {name[:110]}")
    return per_family, busy_ms


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile

    args = sys.argv[1:]
    torch.backends.cudnn.benchmark = "--cudnn-benchmark" in args

    if not torch.cuda.is_available():
        print("profile_torch_cascade: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    from damvsnet_tpu_torch.ops.kernels import build
    build.build()
    train = "--train" in args
    agg_mode = args[args.index("--agg-mode") + 1] if "--agg-mode" in args else "adaptive"
    fused = "--nonfused" not in args and agg_mode == "adaptive"
    if "--nonfused" in args and not train:
        raise SystemExit("--nonfused profiles a training step: pass --train")
    variant = args[args.index("--variant") + 1] if "--variant" in args else None
    if variant not in VARIANTS:
        raise SystemExit(f"--variant {variant}: one of fmt, georeg")
    unit, (run, parts) = (("step", training_step(fused, agg_mode, variant)) if train
                          else ("request", serving_request(agg_mode, variant)))

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        for _ in range(REPEATS):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    per_kernel, busy_ms = device_activities(prof)
    print(f"card: {smi}")
    print(f"{REPEATS} {unit}s: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, "
          f"idle share {1 - busy_ms / wall_ms:.4f}")
    per_family, _ = print_families(per_kernel, unit, 25)
    per_span = spans.reduce(prof)
    print(f"the port's spans (per {unit}):")
    print(spans.table(per_span, REPEATS))
    print(f"slowest convolutions by input shapes (ms per {unit}, calls per {unit}):")
    convs = [e for e in prof.key_averages(group_by_input_shape=True)
             if e.key.startswith("aten::cudnn_convolution")]
    for e in sorted(convs, key=lambda e: -e.device_time_total)[:10]:
        print(f"  {e.device_time_total / 1e3 / REPEATS:9.3f}  {e.count / REPEATS:6.1f}  "
              f"{e.key} {e.input_shapes[:2]}")
    parts_ms = {}
    for name, fn in parts.items():
        fn()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as part:
            for _ in range(REPEATS):
                fn()
            torch.cuda.synchronize()
        part_kernels, _ = device_activities(part)
        parts_ms[name] = sum(ms for ms, _ in part_kernels.values()) / REPEATS
        print(f"{name} alone: {parts_ms[name]:.3f} device ms per call, "
              f"{sum(n for _, n in part_kernels.values()) / REPEATS:.0f} device activities")
        print_families(part_kernels, "call", 15)
    if "--trace" in args:
        path = args[args.index("--trace") + 1]
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        prof.export_chrome_trace(path)
    print(json.dumps({
        "card": smi, "workload": "training" if train else "serving",
        "fused_train": fused if train else None,
        "agg_mode": agg_mode, "variant": variant, f"{unit}s": REPEATS,
        f"wall_ms_per_{unit}": wall_ms / REPEATS,
        f"device_busy_ms_per_{unit}": busy_ms / REPEATS,
        "idle_share": 1 - busy_ms / wall_ms,
        f"family_ms_per_{unit}": {k: v / REPEATS for k, v in per_family.items()},
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "cudnn_benchmark": torch.backends.cudnn.benchmark,
        f"device_activities_per_{unit}": sum(n for _, n in per_kernel.values()) / REPEATS,
        "parts_device_ms": parts_ms, **per_span}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
