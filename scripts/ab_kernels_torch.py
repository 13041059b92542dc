"""Compare the port's CUDA kernels between this checkout and another one on
one card.

    python3 scripts/ab_kernels_torch.py OTHER_TREE [--out DIR]

OTHER_TREE is another checkout of the repository (e.g. the parent commit
unpacked with ``git archive``). Two checks:

  * code: K1 (csrc/fused_costvol.cu) and K3 (csrc/fused_costvol_bwd.cu)
    are built in both trees as damvsnet_tpu_torch.ops.kernels.build does,
    their SASS dumped with cuobjdump, and the two dumps diffed after the
    lines that name the build's input file (``identifier = ...``) are
    dropped; each diff goes to DIR/<kernel>.sass.diff and its count of
    changed lines is printed;
  * time: K1 at the three serving shapes (1152x864, N=5, bf16, ndepths
    64/32/8, random features seen by a rig of five cameras on a baseline),
    one process per tree in the order other, this, this, other: the
    wrapper's time by CUDA events and the kernel's device time alone by
    torch.profiler.

Prints one JSON line per result and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import difflib
import json
import os
import subprocess
import sys
from pathlib import Path

THIS_TREE = Path(__file__).resolve().parent.parent
KERNELS = ("fused_costvol", "fused_costvol_bwd")
STAGES = ((216, 288, 32, 64), (432, 576, 16, 32), (864, 1152, 8, 8))  # h, w, C, D
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
    build.build(KERNELS)
    print(json.dumps({k: str(build.library_path(k)) for k in KERNELS}))


def sass(library: str) -> list[str]:
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", library], check=True, capture_output=True,
                         text=True).stdout
    return [line for line in out.splitlines() if "identifier =" not in line]


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


def time_k1():
    """(In a tree's process.) K1's wrapper and device time per stage."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from damvsnet_tpu_torch.nn.aggweight import AggWeightNetVolume, fold_aggweight
    from damvsnet_tpu_torch.ops.kernels import fused_costvol as K
    dev = torch.device("cuda")
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
            def call():
                return K.fused_adaptive_cost_volume(feas[0], feas[1:], projs[0], projs[1:],
                                                    dv, *wts)
            for _ in range(3):
                call()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                call()
            end.record()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    call()
                torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA and "fused_costvol_kernel" in e.name)
        print(json.dumps({"stage": stage, "shape": [1, d, h, w, c],
                          "ms": start.elapsed_time(end) / 20, "kernel_ms": us / 1e3 / 20}))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("other_tree", nargs="?")
    ap.add_argument("--out", default="chiprun_out/ab_kernels")
    ap.add_argument("--build", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--time", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.build:
        return build_libraries()
    if args.time:
        return time_k1()
    other = Path(args.other_tree).resolve()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    print("card:", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    libs = {tag: json.loads(in_tree(tree, "--build").splitlines()[-1])
            for tag, tree in (("other", other), ("this", THIS_TREE))}
    for kernel in KERNELS:
        a, b = sass(libs["other"][kernel]), sass(libs["this"][kernel])
        diff = list(difflib.unified_diff(a, b, "other", "this", lineterm="", n=1))
        (out / f"{kernel}.sass.diff").write_text("\n".join(diff) + "\n")
        changed = sum(1 for line in diff if line[:1] in "+-"
                      and not line.startswith(("+++", "---")))
        print(json.dumps({"kernel": kernel, "sass_lines": [len(a), len(b)],
                          "changed_lines": changed}), flush=True)
    for tag, tree in (("other", other), ("this", THIS_TREE), ("this", THIS_TREE),
                      ("other", other)):
        for line in in_tree(tree, "--time").splitlines():
            print(json.dumps({"tree": tag, **json.loads(line)}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
