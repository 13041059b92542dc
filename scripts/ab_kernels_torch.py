"""Compare the port's kernels between this checkout and another one on one
card.

    python3 scripts/ab_kernels_torch.py OTHER_TREE [--out DIR] [--serving-only]

OTHER_TREE is another checkout of the repository, or of its
``damvsnet_tpu_torch`` package alone (e.g. the parent commit unpacked with
``git archive``). Two checks:

  * code: every library of csrc/*.cu that both trees have is built in
    both as damvsnet_tpu_torch.ops.kernels.build does, its SASS dumped with
    cuobjdump, and the two dumps diffed after the lines that name the
    build's input file (``identifier = ...``) are dropped: as dumped (to
    DIR/<library>.sass.diff), and with the functions' names demangled by
    cu++filt, which hides the per-source hash of the anonymous namespace,
    and the functions in name order (DIR/<library>.demangled.diff); each
    diff's count of changed lines is printed;
  * time, one process per tree in the order other, this, this, other:
      - K1 at the three serving shapes (1152x864, N=5, bf16, ndepths
        64/32/8, random features seen by a rig of five cameras on a
        baseline);
      - at the same shapes and inputs, K4's sampler (the four source views'
        launches of a stage), the variance cost volume by the tree's
        serving route (K4's variance entry where the tree has one, else the
        sampler once per view and the eager fp32 sums: its device time is
        that of every device activity of the call), and K2 on a
        fp32 and a bf16 cost (a tree whose K2 takes only fp32 gets the
        bf16 cost upcast first, as its cascade did);
      - K6, FMT's linear attention, at a served FMT request's three shapes
        (62,208 tokens, bf16; query and key batches 1 and 1, 4 and 4, 4
        and 1, 4 calls each), beside its plain chain (``nn/fmt.py``'s
        einsums, every device activity of the call); a tree without K6
        times its plain chain alone;
      - unless --serving-only, K3 and K1 at the three training shapes
        (512x640, B=4, N=5, bf16,
        the synthetic scenes' cameras, smooth random features, a seeded
        cotangent) with two sets of hypotheses: "wide", those of
        chip_smoke.py phase 6 (stage 1 the uniform [B, D] sweep, stages 2-3
        sorted random over the whole range), and "narrow", like ADIA's at
        stages 2-3 (stage 1 the same sweep; then D hypotheses evenly over a
        band of +-4 (stage 2) or +-2 (stage 3) stage-1 intervals around
        the scene's smooth depth map, plus a seeded smooth offset);
    each the wrapper's time by CUDA events and the kernel's device time
    alone by torch.profiler, the kernels found by name keys that both
    trees' kernels carry. Beside each K3 row: its 16-byte source-gradient
    atomics, reckoned for one atomic per in-image tap and 4 channels (the
    first design's scatter, counted on the plain grid), and, where the
    tree's K3 counts them, as counted by the kernel.

Prints one JSON line per result and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import difflib
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

THIS_TREE = Path(__file__).resolve().parent.parent
K1_KEY, K3_KEY = "fused_costvol_kernel", "fused_costvol_bwd_kernel"
K2_KEY, K4_KEY, K4_VARIANCE_KEY = "probstats_kernel", "sweep_sampler_kernel", "sweep_variance_kernel"
K6_KEY, FMT_TOKENS = "linear_attn_", 216 * 288
K6_CALLS = (((1, 1), 4), ((4, 4), 4), ((4, 1), 4))  # (query, key batch), calls a request
ANY_KERNEL = ""  # every device activity of the call
STAGES = ((216, 288, 32, 64), (432, 576, 16, 32), (864, 1152, 8, 8))  # h, w, C, D
TRAIN_STAGES = ((128, 160, 32, 64), (256, 320, 16, 32), (512, 640, 8, 8))
TRAIN_B, D0, NARROW_HALF_BAND = 4, 192, (None, 4, 2)  # in stage-1 intervals
NVIEWS = 5


def in_tree(tree: Path, *args: str) -> str:
    """Run this script with ``args`` in a process that imports the
    package of ``tree``; returns its standard output."""
    env = dict(os.environ, PYTHONPATH=str(tree))
    return subprocess.run([sys.executable, str(Path(__file__).resolve()), *args],
                          cwd=tree, env=env, check=True, capture_output=True,
                          text=True).stdout


def build_libraries():
    """(In a tree's process.) Build the kernels; print their library paths."""
    from damvsnet_tpu_torch.ops.kernels import build
    names = sorted(p.stem for p in build.CSRC.glob("*.cu"))  # an older build.py lists none
    build.build(names)
    print(json.dumps({k: str(build.library_path(k)) for k in names}))


def sass(library: str, demangled: bool = False) -> list[str]:
    """The library's SASS less the lines naming the input file; demangled:
    the names through cu++filt and the functions in name order."""
    tools = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin")
    out = subprocess.run([os.path.join(tools, "cuobjdump"), "-sass", library], check=True,
                         capture_output=True, text=True).stdout
    lines = [line for line in out.splitlines() if "identifier =" not in line]
    if not demangled:
        return lines
    lines = subprocess.run([os.path.join(tools, "cu++filt")], input="\n".join(lines),
                           check=True, capture_output=True, text=True).stdout.splitlines()
    parts = [[]]
    for line in lines:
        if "Function :" in line:
            parts.append([])
        parts[-1].append(line)
    return parts[0] + [line for part in sorted(parts[1:]) for line in part]


def sass_diff(a: list[str], b: list[str], path: Path) -> int:
    """Write the unified diff of two dumps to ``path``; its changed lines."""
    diff = list(difflib.unified_diff(a, b, "other", "this", lineterm="", n=1))
    path.write_text("\n".join(diff) + "\n")
    return sum(1 for line in diff if line[:1] in "+-" and not line.startswith(("+++", "---")))


def fused_projs(h, w, dev):
    """Five fused K [I | t] projections, the cameras side by side."""
    import torch
    f = 1.2 * w
    k = torch.tensor([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], device=dev)
    projs = []
    for v in range(NVIEWS):
        p = torch.eye(4, device=dev)
        p[:3, :3] = k
        p[:3, 3] = k @ torch.tensor([0.1 * v, 0.05 * v, 0.0], device=dev)
        projs.append(p[None])
    return projs


def timed(fn, key, iters=20):
    """(wrapper ms by CUDA events, device ms of the kernels named like
    ``key``) per call, after warm-up."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and key in e.name
             and not e.name.startswith("Activity Buffer"))
    return start.elapsed_time(end) / iters, us / 1e3 / iters


def smooth(b, h, w, c, gen, dev):
    """A smooth random [B, H, W, C] field (features are smooth at the scale
    of a tap)."""
    import torch
    lo = torch.randn(b, c, max(h // 8, 2), max(w // 8, 2), generator=gen, device=dev)
    return torch.nn.functional.interpolate(lo, size=(h, w), mode="bilinear").permute(0, 2, 3, 1)


def time_serving_k1(dev):
    import torch
    from damvsnet_tpu_torch.nn.aggweight import AggWeightNetVolume, fold_aggweight
    from damvsnet_tpu_torch.ops.kernels import fused_costvol as K
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.manual_seed(0)
    for stage, (h, w, c, d) in enumerate(STAGES, 1):
        feas = [torch.randn(1, h, w, c, generator=gen, device=dev).bfloat16()
                for _ in range(NVIEWS)]
        projs = fused_projs(h, w, dev)
        if stage == 1:
            dv = torch.linspace(4, 8, d, device=dev)[None]
        else:
            dv = (4 + 4 * torch.rand(1, d, h, w, generator=gen, device=dev)).sort(dim=1).values
        wts = fold_aggweight(AggWeightNetVolume(c).to(dev).eval())
        with torch.inference_mode():
            ms, kernel_ms = timed(lambda: K.fused_adaptive_cost_volume(
                feas[0], feas[1:], projs[0], projs[1:], dv, *wts), K1_KEY)
        print(json.dumps({"kernel": "K1", "path": "serving", "stage": stage,
                          "shape": [1, d, h, w, c], "ms": ms, "kernel_ms": kernel_ms}))


def time_serving_k4_k2(dev):
    """K4's sampler, the variance route and K2 at the three serving shapes
    (the inputs of time_serving_k1)."""
    import torch
    from damvsnet_tpu_torch.ops.costvol import variance_cost_volume
    from damvsnet_tpu_torch.ops.kernels import probstats
    from damvsnet_tpu_torch.ops.kernels import sweep_sampler as S
    gen = torch.Generator(device=dev).manual_seed(0)
    variance_entry = getattr(S, "plane_sweep_variance", None)
    for stage, (h, w, c, d) in enumerate(STAGES, 1):
        feas = [torch.randn(1, h, w, c, generator=gen, device=dev).bfloat16()
                for _ in range(NVIEWS)]
        projs = fused_projs(h, w, dev)
        if stage == 1:
            dv = torch.linspace(4, 8, d, device=dev)[None]
        else:
            dv = (4 + 4 * torch.rand(1, d, h, w, generator=gen, device=dev)).sort(dim=1).values
        base = {"path": "serving", "stage": stage, "shape": [1, d, h, w, c]}
        with torch.inference_mode():
            ms, kernel_ms = timed(lambda: [S.plane_sweep_sample(x, p, projs[0], dv)
                                           for x, p in zip(feas[1:], projs[1:])], K4_KEY)
            print(json.dumps({"kernel": "K4 sampler", **base, "views": NVIEWS - 1, "ms": ms,
                              "kernel_ms": kernel_ms}), flush=True)
            if variance_entry is not None:
                def route():
                    return variance_entry(feas[0], feas[1:], projs[0], projs[1:], dv)
                _, entry_ms = timed(route, K4_VARIANCE_KEY)
            else:
                def route():
                    return variance_cost_volume(feas[0], feas[1:], projs[0], projs[1:], dv,
                                                warp=S.plane_sweep_sample)
                entry_ms = None
            ms, route_kernel_ms = timed(route, ANY_KERNEL)
            print(json.dumps({"kernel": "K4 variance route", **base,
                              "route": "variance entry" if entry_ms is not None
                              else "sampler + eager sums", "ms": ms,
                              "device_ms": route_kernel_ms, "kernel_ms": entry_ms}), flush=True)
            cost32 = 3 * torch.randn(1, d, h, w, generator=gen, device=dev)
            for tag, cost in (("fp32", cost32), ("bf16", cost32.bfloat16())):
                try:
                    probstats.prob_volume_stats_fused(cost, dv)
                    upcast = False
                except ValueError:  # a K2 that takes only fp32
                    upcast = True

                def stats():
                    return probstats.prob_volume_stats_fused(cost.float() if upcast else cost, dv)
                ms, device_ms = timed(stats, ANY_KERNEL, 50)
                _, kernel_ms = timed(stats, K2_KEY, 50)
                print(json.dumps({"kernel": "K2", **base, "shape": [1, d, h, w], "cost": tag,
                                  "upcast_first": upcast, "ms": ms, "device_ms": device_ms,
                                  "kernel_ms": kernel_ms}), flush=True)
        del feas
        torch.cuda.empty_cache()


def time_serving_k6(dev):
    """K6 and the plain chain at a served FMT request's shapes: ms a call."""
    import importlib.util
    import torch
    from damvsnet_tpu_torch.nn import fmt
    has_k6 = importlib.util.find_spec("damvsnet_tpu_torch.ops.kernels.linear_attention")
    gen = torch.Generator(device=dev).manual_seed(0)
    for (bq, bk), calls in K6_CALLS:
        q = torch.randn(bq, FMT_TOKENS, 8, 4, generator=gen, device=dev).bfloat16()
        k, v = (torch.randn(bk, FMT_TOKENS, 8, 4, generator=gen, device=dev).bfloat16()
                for _ in range(2))
        row = {"kernel": "K6", "path": "serving", "shape": [bq, bk, FMT_TOKENS], "calls": calls}
        with torch.inference_mode():
            if has_k6:
                from damvsnet_tpu_torch.ops.kernels import linear_attention as la
                row["ms"], row["kernel_ms"] = timed(
                    lambda: la.fused_linear_attention(q, k, v), K6_KEY, 50)
                plain = la.linear_attention_plain
            else:
                plain = fmt.linear_attention
            row["plain_ms"], row["plain_device_ms"] = timed(lambda: plain(q, k, v), ANY_KERNEL)
        print(json.dumps(row), flush=True)


def reckoned_atomics(projs, dv, h, w, c):
    """16-byte atomics of a scatter of every in-image tap, 4 channels each."""
    import torch
    from damvsnet_tpu_torch.ops.warp import plane_sweep_grid
    taps = 0
    for p in projs[1:]:
        px, py = plane_sweep_grid(p, projs[0], dv, h, w)
        x0, y0 = px.floor(), py.floor()
        for ox in (0, 1):
            for oy in (0, 1):
                x, y = x0 + ox, y0 + oy
                taps += int(((x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)).sum())
        del px, py, x0, y0
    torch.cuda.empty_cache()
    return taps * (c // 4)


def training_hypotheses(kind, stage, batch, lo, hi, gen, dev):
    import torch
    h, w, _, d = TRAIN_STAGES[stage - 1]
    b = lo.shape[0]
    if stage == 1:
        t = torch.linspace(0, 1, d, device=dev)[None]
        return lo[:, None] + (hi - lo)[:, None] * t
    if kind == "wide":
        u = torch.rand(b, d, h, w, generator=gen, device=dev).sort(dim=1).values
        return lo[:, None, None, None] + (hi - lo)[:, None, None, None] * u
    interval = (hi - lo) / (TRAIN_STAGES[0][3] - 1)
    depth = torch.as_tensor(batch["depth"][f"stage{stage}"], device=dev)  # [B, h, w]
    depth = torch.where(depth > 0, depth, (lo + hi)[:, None, None] / 2)
    offset = smooth(b, h, w, 1, gen, dev)[..., 0] * interval[:, None, None]
    half = NARROW_HALF_BAND[stage - 1] * interval
    t = torch.linspace(-1, 1, d, device=dev)[None, :, None, None]
    return (depth + offset)[:, None] + half[:, None, None, None] * t


def time_training(dev):
    import numpy as np
    import torch
    from damvsnet_tpu_torch.data.common import collate
    from damvsnet_tpu_torch.data.synthetic import make_synthetic_sample
    from damvsnet_tpu_torch.model.cascade import fuse_projection_matrices
    from damvsnet_tpu_torch.nn.aggweight import AggWeightNetVolume, fold_aggweight
    from damvsnet_tpu_torch.ops.kernels import fused_costvol as K
    counts = "atomics" in inspect.signature(K._launch_backward).parameters
    h1, w1 = TRAIN_STAGES[-1][:2]
    batch = collate([make_synthetic_sample(height=h1, width=w1, nviews=NVIEWS, ndepths=D0,
                                           seed=k) for k in range(TRAIN_B)])
    lo = torch.as_tensor(np.ascontiguousarray(batch["depth_values"][:, 0]), device=dev)
    hi = torch.as_tensor(np.ascontiguousarray(batch["depth_values"][:, -1]), device=dev)
    torch.manual_seed(0)
    for stage, (h, w, c, d) in enumerate(TRAIN_STAGES, 1):
        gen = torch.Generator(device=dev).manual_seed(stage)
        fused = fuse_projection_matrices(
            torch.as_tensor(batch["proj_matrices"][f"stage{stage}"], device=dev))
        projs = [fused[:, v] for v in range(NVIEWS)]
        feas = [smooth(TRAIN_B, h, w, c, gen, dev).bfloat16().contiguous()
                for _ in range(NVIEWS)]
        wts = fold_aggweight(AggWeightNetVolume(c).to(dev).eval())
        cot = torch.randn(TRAIN_B, d, h, w, c, generator=gen, device=dev).bfloat16()
        for kind in ("wide", "narrow"):
            if stage == 1 and kind == "narrow":
                continue  # stage 1 is the same uniform sweep in both sets
            dv = training_hypotheses(kind, stage, batch, lo, hi, gen, dev)
            args = (feas[0], feas[1:], projs[0], projs[1:], dv, *wts)
            with torch.no_grad():
                k3_ms, k3_kernel_ms = timed(
                    lambda: K.fused_adaptive_cost_volume_backward(cot, *args), K3_KEY, 10)
                k1_ms, k1_kernel_ms = timed(lambda: K.fused_adaptive_cost_volume(*args), K1_KEY, 10)
                row = {"kernel": "K3+K1", "path": "training", "hypotheses": kind,
                       "stage": stage, "shape": [TRAIN_B, d, h, w, c], "k3_ms": k3_ms,
                       "k3_kernel_ms": k3_kernel_ms, "k1_ms": k1_ms,
                       "k1_kernel_ms": k1_kernel_ms,
                       "atomics_reckoned_per_tap": reckoned_atomics(projs, dv, h, w, c)}
                if counts:
                    prepare = getattr(K, "_prepare", None) or K.prepare_views
                    L = prepare("ab", feas[0], feas[1:], projs[0], projs[1:], dv)
                    counter = torch.zeros(1, dtype=torch.int64, device=dev)
                    K._launch_backward(L, K._params(*wts, L), feas[0], feas[1:], cot,
                                       atomics=counter)
                    row["atomics_counted"] = int(counter)
            print(json.dumps(row), flush=True)
            del dv, args
        del feas, cot
        torch.cuda.empty_cache()


def time_kernels(training=True):
    """(In a tree's process.) K1, K4, K2 and K6 at the serving shapes; K3
    and K1 at the training shapes."""
    import torch
    dev = torch.device("cuda")
    time_serving_k1(dev)
    time_serving_k4_k2(dev)
    time_serving_k6(dev)
    if training:
        time_training(dev)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("other_tree", nargs="?")
    ap.add_argument("--out", default="chiprun_out/ab_kernels")
    ap.add_argument("--serving-only", action="store_true",
                    help="skip K3 and K1 at the training shapes")
    ap.add_argument("--build", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--time", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.build:
        return build_libraries()
    if args.time:
        return time_kernels(training=not args.serving_only)
    other = Path(args.other_tree).resolve()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    print("card:", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    libs = {tag: json.loads(in_tree(tree, "--build").splitlines()[-1])
            for tag, tree in (("other", other), ("this", THIS_TREE))}
    for lib in sorted(set(libs["other"]) & set(libs["this"])):
        a, b = sass(libs["other"][lib]), sass(libs["this"][lib])
        da, db = sass(libs["other"][lib], True), sass(libs["this"][lib], True)
        print(json.dumps({"library": lib, "sass_lines": [len(a), len(b)],
                          "changed_lines": sass_diff(a, b, out / f"{lib}.sass.diff"),
                          "changed_lines_demangled": sass_diff(
                              da, db, out / f"{lib}.demangled.diff")}), flush=True)
    for tag, tree in (("other", other), ("this", THIS_TREE), ("this", THIS_TREE),
                      ("other", other)):
        flags = ["--time"] + (["--serving-only"] if args.serving_only else [])
        for line in in_tree(tree, *flags).splitlines():
            print(json.dumps({"tree": tag, **json.loads(line)}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
