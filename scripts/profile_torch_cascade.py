"""Where the PyTorch/CUDA port's serving forward spends device time.

    python3 scripts/profile_torch_cascade.py [--cudnn-benchmark] [--trace PATH]
                                          (repository root, one GPU)

Runs the serving cascade (1152x864, N=5, ndepths 64/32/8, bf16, the trained
weights of weights/bench_ckpt.npz, the synthetic scene of chip_smoke.py)
through DepthRunner: one warm-up request, then REQUESTS requests under
torch.profiler. Prints device time per kernel family, the top kernels and
the slowest convolutions with their input shapes,
the device's busy and idle share of the profiled wall time, and one JSON
line. ``--trace PATH`` writes the Chrome trace there.

``--cudnn-benchmark`` is a diagnostic, not a serving setting: it lets cuDNN
time its algorithms per shape during the warm-up request
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

REQUESTS = 3
# kernel-name substrings -> family, first match wins
FAMILIES = (
    ("K1 fused cost volume", ("fused_costvol_kernel",)),
    ("K2 prob stats", ("probstats_kernel",)),
    ("convolution", ("conv", "xmma", "gemm", "cudnn", "cutlass", "dgrad", "wgrad",
                     "implicit", "winograd", "sm90", "fft")),
    ("resize", ("upsample", "interp")),
    ("pooling", ("pool",)),
    ("reduction", ("reduce", "softmax", "sort", "min_max")),
    ("copy / layout", ("copy", "memcpy", "memset", "cat", "fill")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def main():
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    args = sys.argv[1:]
    torch.backends.cudnn.benchmark = "--cudnn-benchmark" in args

    if not torch.cuda.is_available():
        print("profile_torch_cascade: no CUDA device", file=sys.stderr)
        return 2
    from damvsnet_tpu_torch.data.synthetic import make_synthetic_sample
    from damvsnet_tpu_torch.infer import DepthRunner
    from damvsnet_tpu_torch.model import CascadeMVSNet
    from damvsnet_tpu_torch.ops.kernels import build
    from damvsnet_tpu_torch.utils.weights import load_bench_weights

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    build.build()
    sample = make_synthetic_sample(height=864, width=1152, nviews=5, ndepths=192,
                                   with_gt=False, seed=3)
    batch = {"imgs": sample["imgs"][None],
             "proj_matrices": {k: v[None] for k, v in sample["proj_matrices"].items()},
             "depth_values": sample["depth_values"][None]}
    model = CascadeMVSNet(ndepths=(64, 32, 8), compute_dtype=torch.bfloat16)
    load_bench_weights(model, "weights/bench_ckpt.npz")
    runner = DepthRunner(model)
    runner(batch)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        for _ in range(REQUESTS):
            runner(batch)
        wall_ms = (time.perf_counter() - t0) * 1e3

    # device-side activities only (kernels, memcpys, memsets): operator
    # rows of key_averages() repeat their kernels' time
    per_kernel = defaultdict(float)
    calls = defaultdict(int)
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA or evt.name.startswith("Activity Buffer"):
            continue
        per_kernel[evt.name] += evt.time_range.elapsed_us() / 1e3
        calls[evt.name] += 1
    per_family = defaultdict(float)
    for name, ms in per_kernel.items():
        per_family[family(name)] += ms
    busy_ms = sum(per_kernel.values())

    print(f"card: {smi}")
    print(f"{REQUESTS} requests: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, "
          f"idle share {1 - busy_ms / wall_ms:.4f}")
    for fam, ms in sorted(per_family.items(), key=lambda kv: -kv[1]):
        print(f"  {fam:24s} {ms / REQUESTS:9.3f} ms/request  {ms / busy_ms:6.1%}")
    print("top device activities (ms per request, count per request):")
    for name, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:25]:
        print(f"  {ms / REQUESTS:9.3f}  {calls[name] / REQUESTS:6.1f}  {name[:110]}")
    print("slowest convolutions by input shapes (ms per request, calls per request):")
    convs = [e for e in prof.key_averages(group_by_input_shape=True)
             if e.key.startswith("aten::cudnn_convolution")]
    for e in sorted(convs, key=lambda e: -e.device_time_total)[:10]:
        print(f"  {e.device_time_total / 1e3 / REQUESTS:9.3f}  {e.count / REQUESTS:6.1f}  "
              f"{e.key} {e.input_shapes[:2]}")
    if "--trace" in args:
        path = args[args.index("--trace") + 1]
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        prof.export_chrome_trace(path)
    print(json.dumps({
        "card": smi, "requests": REQUESTS,
        "wall_ms_per_request": wall_ms / REQUESTS,
        "device_busy_ms_per_request": busy_ms / REQUESTS,
        "idle_share": 1 - busy_ms / wall_ms,
        "family_ms_per_request": {k: v / REQUESTS for k, v in per_family.items()},
        "cudnn_benchmark": torch.backends.cudnn.benchmark,
        "device_activities_per_request": sum(calls.values()) / REQUESTS}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
