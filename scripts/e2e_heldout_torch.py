"""The accuracy chain's held-out depth epoch by epoch, and with its
BatchNorm statistics re-estimated: how far scripts/e2e_synthetic_torch.py's
result moves from run to run, and whether the running statistics that
serving folds are why.

    python3 scripts/e2e_heldout_torch.py --runs 3 --out heldout.json -- \\
        --align_corners --epochs 16 --d0 48 --ndepths 32,16,8 --lr 1e-3

Runs the chain's ``main`` (the arguments after ``--``) ``--runs`` times, each
in a work directory of its own, then for each run serves the held-out scene
(the chain's ``serve``: DepthRunner, the depth error against the analytic
depth) from every epoch's checkpoint with the running statistics as
trained, the momentum-0.1 averages the training steps leave; and from the
last checkpoint once more with every BatchNorm's statistics re-estimated
as the plain mean, over one pass of the training set in training mode
without gradients, of the batch statistics the training steps normalize
with, then fused and scored as the chain does. Prints one JSON line a run
and writes them all to ``--out``.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def chain_module():
    spec = importlib.util.spec_from_file_location(
        "e2e_synthetic_torch", os.path.join(REPO, "scripts", "e2e_synthetic_torch.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_epoch(e2e, cargs, dev, workdir, epoch):
    """The model of epoch ``epoch``'s checkpoint (weights and statistics)."""
    import torch
    payload = torch.load(os.path.join(workdir, "ckpt", f"ckpt_{epoch:06d}.pt"),
                         map_location="cpu", weights_only=True)
    model = e2e.build_model(cargs, dev, seed=2)
    model.load_state_dict(payload["model"])
    return model


def reestimate_statistics(model, cargs, dev):
    """Every BatchNorm's running mean and variance set to the plain mean of
    the batch statistics it normalizes with over one pass of the training
    set (training mode, no gradient); the model is left in eval mode."""
    import torch
    from damvsnet_tpu_torch.data.common import DataLoader
    from damvsnet_tpu_torch.data.synthetic import SyntheticDataset
    from damvsnet_tpu_torch.nn import blocks
    from damvsnet_tpu_torch.train.loop import batch_to_device

    sums = {}
    inner = blocks._batch_stats_norm

    def accumulate(y, bn, relu):
        var, mean = torch.var_mean(y.float(), dim=[0] + list(range(2, y.dim())), correction=0)
        s = sums.setdefault(bn, [0.0, 0.0, 0])
        s[0], s[1], s[2] = s[0] + mean, s[1] + var, s[2] + 1
        return inner(y, bn, relu)

    train_ds = SyntheticDataset(mode="train", nviews=cargs.nviews, ndepths=cargs.d0,
                                height=cargs.height, width=cargs.width,
                                length=cargs.epoch_len)
    loader = DataLoader(train_ds, cargs.batch_size, num_workers=2)
    blocks._batch_stats_norm = accumulate
    try:
        model.train()
        with torch.no_grad():
            for batch in loader.iter_epoch(0):
                b = batch_to_device(batch, dev)
                model(b["imgs"], b["proj_matrices"], b["depth_values"])
    finally:
        blocks._batch_stats_norm = inner
    with torch.no_grad():
        for bn, (mean, var, n) in sums.items():
            bn.running_mean.copy_(mean / n)
            bn.running_var.copy_(var / n)
    model.eval()
    return len(sums)


def main(argv=None):
    ap = argparse.ArgumentParser("held-out depth of the accuracy chain, epoch by epoch")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--out", required=True)
    ap.add_argument("--workroot", default=None)
    ap.add_argument("chain_argv", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    chain_argv = args.chain_argv[1:] if args.chain_argv[:1] == ["--"] else args.chain_argv
    from damvsnet_tpu_torch.core import imageio
    from damvsnet_tpu_torch.utils.device import resolve_device

    e2e = chain_module()
    cargs = e2e.parse_args(chain_argv)
    dev = resolve_device(cargs.device)
    root = args.workroot or tempfile.mkdtemp(prefix="e2e_heldout_")
    missing = imageio.codecs_missing()
    results = []
    for run in range(args.runs):
        workdir = os.path.join(root, f"run{run}")
        report = e2e.main(chain_argv + ["--workdir", workdir,
                                        "--out", os.path.join(workdir, "accuracy.json")])
        datadir = os.path.join(workdir, "data")
        codec = imageio.numpy_codec() if missing else contextlib.nullcontext()
        by_epoch = []
        with codec:
            for epoch in range(1, cargs.epochs + 1):
                rep = {"peak_gib": {}}
                e2e.serve(cargs, dev, load_epoch(e2e, cargs, dev, workdir, epoch), datadir,
                          os.path.join(workdir, f"heldout_{epoch}"), rep)
                by_epoch.append({k: rep["depth"][k] for k in
                                 ("frac_within_1_interval", "abs_err_mm_mean")})
            model = load_epoch(e2e, cargs, dev, workdir, cargs.epochs)
            n_bn = reestimate_statistics(model, cargs, dev)
            rep = {"peak_gib": {}}
            outdir = os.path.join(workdir, "reestimated")
            e2e.serve(cargs, dev, model, datadir, outdir, rep)
            e2e.fuse_and_score(cargs, dev, datadir, outdir, missing, rep)
        result = {
            "run": run, "device": report["device"],
            "final_train_loss": report["train_curve"][-1]["loss"],
            "chain": {"depth": report["depth"], "dtu_protocol": report["dtu_protocol"]},
            "heldout_by_epoch": by_epoch,
            "reestimated_statistics": {"batchnorms": n_bn, "depth": rep["depth"],
                                       "dtu_protocol": rep["dtu_protocol"]}}
        print("heldout", json.dumps(result), flush=True)
        results.append(result)
    with open(args.out, "w") as f:
        json.dump({"chain_argv": chain_argv, "runs": results}, f, indent=1)
    return results


if __name__ == "__main__":
    main()
