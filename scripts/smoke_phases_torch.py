"""Some phases of chip_smoke.py alone, from one or more trees, on one GPU.

    python3 scripts/smoke_phases_torch.py 14 15 16
    python3 scripts/smoke_phases_torch.py 5 7 --trees _build/parent . . _build/parent

Each tree (a checkout of the repository; default the one this script is
in) runs in a process of its own, in the order given, so listing a parent
tree around this one (parent / this / this / parent) compares two commits
on the same card. The kernels are built in each tree first. Phases: 3 (K1
against its plain version at the serving shapes, and past 16 source views),
4 (K2), 4b (K5, CostRegNet's prob conv, against F.conv3d, timed beside
cuDNN), 4c (K6, FMT's linear attention, against fp64, timed beside the
plain chain), 5 (the adaptive serving cascade), 6 (K3 at the training shapes), 7
(the fused training step), 8 (K4's sampler and variance entry), 9 (the
variance serving cascade), 13 (the test CLI
on a synthetic DTU-layout scene), 14 (FMT serving),
15 (FMT training, undetached), 16 (GeoReg / refine / U-Net serving), and
the ranks' phases, each two processes of chip_smoke.py on the card: 17
(data-parallel fused training), 18 (the training CLI on 2 ranks), 19 (the
scan-parallel test CLI), 20 (FMT serving with sequence parallelism; it
runs phase 14 first when the list has not, for its bf16 limit), and the
depth-slab axis: 21 (slab serving on 2 ranks), 22 (slab training: the
fused step on 2 ranks and on the 2x2 mesh, the non-fused step on 2 ranks;
its one-process peak is phase 10's, not measured here), 23 (the training
CLI on the 2x2 mesh, then a 1-rank resume), 24 (the Tanks-and-Temples
recipe, scripts/test_tnt_torch.sh, at 1920x1056 with 11 views) and 25 (the
accuracy chain, scripts/e2e_synthetic_torch.py, for 2 epochs). Each
prints its chip_smoke.py lines, prefixed with the tree, and fails as the
smoke does.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = """
import sys, tempfile, torch
import chip_smoke as c
from damvsnet_tpu_torch.data.synthetic import make_synthetic_sample
from damvsnet_tpu_torch.model import CascadeMVSNet
from damvsnet_tpu_torch.ops.kernels import build
from damvsnet_tpu_torch.utils.weights import load_bench_weights
build.build()
print("card:", c.nvidia_smi(), flush=True)
dev = torch.device("cuda")
sample = make_synthetic_sample(height=c.HEIGHT, width=c.WIDTH, nviews=c.NVIEWS,
                               ndepths=c.D0, with_gt=True, seed=c.SEED)
smi, fmt = c.nvidia_smi(), None
workdir = tempfile.TemporaryDirectory()


def serving(**kw):
    model = CascadeMVSNet(ndepths=c.NDEPTHS, compute_dtype=torch.bfloat16, device=dev, **kw)
    load_bench_weights(model, c.SERVING_WEIGHTS)
    return model


for phase in sys.argv[1:]:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if phase == "3":
        model = serving()
        with torch.inference_mode():
            c.phase_k1(sample, model, dev)
        c.phase_k1_many_views(model, dev)
    elif phase == "4":
        with torch.inference_mode():
            c.phase_k2(sample, dev)
    elif phase == "4b":
        with torch.inference_mode():
            c.phase_prob_conv(serving(), dev)
    elif phase == "4c":
        with torch.inference_mode():
            c.phase_linear_attention(dev)
    elif phase == "5":
        c.phase_cascade(sample, serving(), dev)
    elif phase == "6":
        with torch.no_grad():
            c.phase_k3(serving(), dev)
    elif phase == "8":
        model = serving(agg_mode="variance")
        with torch.inference_mode():
            c.phase_k4(sample, model, dev)
            c.phase_k4_variance(sample, model, dev)
            c.phase_k4_variance_many_views(model, dev)
    elif phase == "9":
        c.phase_variance(sample, serving(agg_mode="variance"), dev)
    elif phase == "7":
        c.phase_train(dev)
    elif phase == "13":
        c.phase_test_cli(dev)
    elif phase == "14":
        fmt = c.phase_fmt_serving(sample, dev)[2]
    elif phase == "15":
        c.phase_train_variants(dev)
    elif phase == "16":
        c.phase_variant_serving(sample, dev)
    elif phase == "17":
        c.phase_ddp_train(dev, smi, workdir.name)
    elif phase == "18":
        c.phase_train_cli(smi, workdir.name)
    elif phase == "19":
        rng = float(sample["depth_values"][-1] - sample["depth_values"][0])
        c.phase_scan_parallel(dev, smi, workdir.name, c.DEPTH_TOL_SHARE * rng)
    elif phase == "20":
        if fmt is None:
            fmt = c.phase_fmt_serving(sample, dev)[2]
        c.phase_fmt_sp(sample, dev, smi, workdir.name, fmt["parity"]["bf16"]["tol"])
    elif phase == "21":
        rng = float(sample["depth_values"][-1] - sample["depth_values"][0])
        c.phase_slab_serving(sample, dev, smi, workdir.name, c.DEPTH_TOL_SHARE * rng)
    elif phase == "22":
        c.phase_slab_train(dev, smi, workdir.name)
    elif phase == "23":
        c.phase_slab_cli(smi, workdir.name)
    elif phase == "24":
        c.phase_tnt_recipe(dev)
    elif phase == "25":
        c.phase_accuracy_chain()
    torch.cuda.empty_cache()
workdir.cleanup()
"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("phases", nargs="+",
                    choices=["3", "4", "4b", "4c", "5", "6", "7", "8", "9", "13", "14", "15", "16",
                             "17", "18", "19", "20", "21", "22", "23", "24", "25"])
    ap.add_argument("--trees", nargs="+", default=[REPO])
    args = ap.parse_args()
    for tree in args.trees:
        proc = subprocess.run([sys.executable, "-c", CHILD, *args.phases], cwd=tree,
                              capture_output=True, text=True)
        for line in proc.stdout.splitlines():
            print(f"{tree}: {line}", flush=True)
        if proc.returncode:
            sys.stderr.write(proc.stderr[-4000:])
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
