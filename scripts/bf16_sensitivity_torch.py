"""How far a serving cascade's bf16 depth moves between two runs that should
agree, on one CUDA card: the route through the kernels against itself (is
the run deterministic?), the plain versions against themselves, and the
kernels against the plain versions, each as p999 and max |d depth| per
stage, with cuDNN free to pick its algorithms and with
``torch.backends.cudnn.deterministic``.

    python3 scripts/bf16_sensitivity_torch.py [--config adaptive|fmt|georeg]

adaptive: the trained weights (chip_smoke.py phase 5); fmt: with a seeded
FMT pathway (phase 14); georeg: GeoRegNet2d, RefineNet and the U-Net
FeatureNet seeded (phase 16). 1152x864, N=5, ndepths 64/32/8, the smoke's
scene (seed 3). Prints one JSON line per comparison.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CONFIGS = {"adaptive": ({}, ()),
           "fmt": ({"use_fmt": True}, ("FMT_with_pathway",)),
           "georeg": ({"reg_mode": "georeg", "refine": True, "arch_mode": "unet"},
                      ("feature", "cost_regularization", "refine_network"))}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="fmt", choices=sorted(CONFIGS))
    args = ap.parse_args()

    import numpy as np
    import torch
    from damvsnet_tpu_torch.data.synthetic import make_synthetic_sample
    from damvsnet_tpu_torch.model import CascadeMVSNet
    from damvsnet_tpu_torch.ops.kernels import build
    from damvsnet_tpu_torch.utils.weights import load_bench_weights

    build.build()
    dev = torch.device("cuda")
    config, seeded = CONFIGS[args.config]
    sample = make_synthetic_sample(height=864, width=1152, nviews=5, ndepths=192,
                                   with_gt=True, seed=3)
    torch.manual_seed(3)
    model = CascadeMVSNet(ndepths=(64, 32, 8), compute_dtype=torch.bfloat16, device=dev,
                          **config)
    load_bench_weights(model, "weights/bench_ckpt.npz", seeded)
    imgs = torch.as_tensor(sample["imgs"][None], device=dev)
    projs = {k: torch.as_tensor(v[None], device=dev)
             for k, v in sample["proj_matrices"].items()}
    dvals = torch.as_tensor(sample["depth_values"][None], device=dev)
    rng = float(sample["depth_values"][-1] - sample["depth_values"][0])

    signs = {k: torch.as_tensor(np.random.default_rng(0).choice([-1.0, 1.0], v.shape),
                                dtype=torch.float32, device=dev)
             for k, v in sample["proj_matrices"].items()}

    def run(plain, ulps=0, dtype=torch.bfloat16, cams=False):
        """One forward; ``ulps`` moves the depth range (or, ``cams``, every
        camera-matrix entry up or down at random) by that many fp32 ulps, a
        geometry difference of the size the kernels and the plain versions
        have (they evaluate it in another order)."""
        model.plain, model.compute_dtype = plain, dtype
        dv, pm = dvals, projs
        if cams:
            pm = {k: v * (1.0 + ulps * 2.0 ** -23 * signs[k]) for k, v in projs.items()}
        else:
            dv = dvals * (1.0 + ulps * 2.0 ** -23)
        with torch.inference_mode():
            out = model(imgs, pm, dv)
        return {s: out[s]["depth"].float().cpu().numpy() for s in ("stage1", "stage2", "stage3")}

    def show(name, a, b, **extra):
        row = {"config": args.config, "pair": name, "depth_range": rng, **extra}
        for s in a:
            d = np.abs(a[s] - b[s])
            row[s] = {"p999_abs": float(np.quantile(d, 0.999)), "max_abs": float(d.max())}
        print(json.dumps(row), flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = run(True)
    for ulps in (1, 4):
        show(f"plain vs plain, depth range moved {ulps} fp32 ulps", base, run(True, ulps),
             dtype="bf16")
        show(f"plain vs plain, depth range moved {ulps} fp32 ulps",
             run(True, 0, torch.float32), run(True, ulps, torch.float32), dtype="fp32")
    show("plain vs plain, camera matrices moved 1 fp32 ulp", base, run(True, 1, cams=True),
         dtype="bf16")
    show("plain bf16 vs plain fp32", base, run(True, 0, torch.float32))

    for deterministic in (False, True):
        torch.backends.cudnn.deterministic = deterministic
        runs = {"kernels": [run(False), run(False)], "plain": [run(True), run(True)]}
        pairs = {"kernels vs kernels": (runs["kernels"][0], runs["kernels"][1]),
                 "plain vs plain": (runs["plain"][0], runs["plain"][1]),
                 "kernels vs plain": (runs["kernels"][0], runs["plain"][0])}
        for name, (a, b) in pairs.items():
            show(name, a, b, dtype="bf16", cudnn_deterministic=deterministic)
    torch.backends.cudnn.deterministic = False


if __name__ == "__main__":
    main()
