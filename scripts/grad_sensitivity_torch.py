"""How far the port's training-step gradient moves under a tiny change of
the input images, on the CPU.

    python3 scripts/grad_sensitivity_torch.py [--scenes 2,3] [--eps 1e-7,1e-6]
                                             [--init trained|random]

The cascade of tests/test_torch_train_step.py (ndepths 8/8/8, two
synthetic scenes of 32x32, N=3, fp32, training mode, the staged smooth-L1
+ CPC loss) takes one forward and backward on the scenes' images, and one
more on the images times (1 + eps * n), n standard normal from a fixed
seed. Per parameter tensor it prints max |g_eps - g| / max |g| as a median,
a 90th percentile, the count above 1e-3 and the five largest, for each
eps. The weights are the trained ones of weights/bench_ckpt.npz, or a
seeded random init.

A gradient that is smooth in the images moves by about eps times its
condition; one that jumps at a ReLU kink within reach of eps moves by
percents on many tensors at once. The whole-step parity test's scene pair
is one where the port and the JAX package sit on the same side of every
kink.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from damvsnet_tpu_torch.data.common import collate
from damvsnet_tpu_torch.data.synthetic import make_synthetic_sample
from damvsnet_tpu_torch.losses import cas_mvsnet_loss
from damvsnet_tpu_torch.model import CascadeMVSNet
from damvsnet_tpu_torch.train.loop import batch_to_device
from damvsnet_tpu_torch.utils.weights import load_bench_weights


def gradients(model, init_state, batch, imgs):
    model.load_state_dict(init_state)
    model.train()
    model.zero_grad(set_to_none=True)
    out = model(imgs, batch["proj_matrices"], batch["depth_values"])
    loss = cas_mvsnet_loss(out, imgs, batch["proj_matrices"], batch["depth"],
                           batch["mask"])[0]
    loss.backward()
    return float(loss), {k: p.grad.clone() for k, p in model.named_parameters()}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--scenes", default="2,3")
    p.add_argument("--eps", default="1e-7,1e-6")
    p.add_argument("--init", default="trained", choices=["trained", "random"])
    args = p.parse_args()
    torch.set_num_threads(1)
    torch.manual_seed(0)

    scenes = [int(s) for s in args.scenes.split(",")]
    batch = batch_to_device(collate([make_synthetic_sample(32, 32, 3, 16, seed=s)
                                     for s in scenes]), "cpu")
    model = CascadeMVSNet(ndepths=(8, 8, 8), device="cpu", fused_train=True)
    if args.init == "trained":
        load_bench_weights(model, "weights/bench_ckpt.npz")
    init_state = {k: v.clone() for k, v in model.state_dict().items()}
    noise = torch.from_numpy(np.random.default_rng(5).standard_normal(
        tuple(batch["imgs"].shape)).astype(np.float32))

    # torch's own CPU convolutions (see tests/test_torch_train_loop.py)
    with torch.backends.mkldnn.flags(enabled=False):
        loss, base = gradients(model, init_state, batch, batch["imgs"])
        print(f"scenes {scenes}, {args.init} weights: loss {loss!r}")
        for eps in (float(e) for e in args.eps.split(",")):
            loss_eps, moved = gradients(model, init_state, batch,
                                        batch["imgs"] * (1 + eps * noise))
            rel = sorted((float((moved[k] - g).abs().max() / (g.abs().max() + 1e-30)), k)
                         for k, g in base.items())
            vals = [r for r, _ in rel]
            print(f"eps {eps:g}: loss {loss_eps!r}; per tensor max|dg|/max|g| "
                  f"median {vals[len(vals) // 2]:.3g}, p90 {vals[int(0.9 * len(vals))]:.3g}, "
                  f"above 1e-3: {sum(v > 1e-3 for v in vals)} of {len(vals)}")
            for r, k in rel[-5:]:
                print(f"  {r:.3g}  {k}")


if __name__ == "__main__":
    main()
