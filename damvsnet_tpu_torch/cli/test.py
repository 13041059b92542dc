"""Inference and fusion CLI; counterpart of damvsnet_tpu/cli/test.py (the
reference's test_uni.py:95-117,504-533): per-scene depth inference, the
depth files, then ``--filter_method`` in {dypcd, pcd, consistency, none}.

    python -m damvsnet_tpu_torch.cli.test --dataset general_eval \
        --testpath ... --testlist lists/dtu/test.txt \
        --loadckpt weights/bench_ckpt.npz --outdir ./outputs --filter_method dypcd

One DepthRunner serves every scene of a process; scenes run one after
another. Across ranks (torchrun's environment, as in the JAX CLI's
multi-process launch) the scenes are scan-parallel: rank i infers and
fuses testlist[i::n] into the shared ``--outdir``, on its own card
(``LOCAL_RANK``); ``--dist_backend`` as in the training CLI. It runs on
CUDA, or on the device ``--device`` names, in bf16 on
CUDA and fp32 elsewhere unless ``--dtype`` says otherwise. The consistency
filter votes on that device (infer/fusion_device.py). The eval loaders,
dypcd and pcd need cv2 and PIL; the consistency filter and inference read
and write images through core/imageio.py only. It builds what the JAX
CLI builds from the same flags (``--use_fmt``, ``--grad_method``, which
serving ignores, and ``--share_cr``, which raises in both packages: one
regularizer cannot take the stages' three widths).
"""
from __future__ import annotations

import argparse
import os

_NO_EFFECT = "accepted for the JAX CLI's command lines; no effect in the port"


def build_parser():
    p = argparse.ArgumentParser("damvsnet-tpu-torch test")
    p.add_argument("--dataset", default="general_eval")
    p.add_argument("--testpath", required=True)
    p.add_argument("--testlist", required=True)
    p.add_argument("--loadckpt", default=None,
                   help="a flax flat-path .npz (weights/bench_ckpt.npz) or a "
                        "checkpoint of the port's training CLI (.pt, weights only)")
    p.add_argument("--outdir", default="./outputs")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--numdepth", type=int, default=192)
    p.add_argument("--interval_scale", type=float, default=1.06)
    p.add_argument("--num_view", type=int, default=5)
    p.add_argument("--max_h", type=int, default=864)
    p.add_argument("--max_w", type=int, default=1152)
    p.add_argument("--fix_res", action="store_true")
    p.add_argument("--ndepths", default="64,32,8")
    p.add_argument("--depth_inter_r", default="4,2,1")
    p.add_argument("--cr_base_chs", default="8,8,8")
    p.add_argument("--share_cr", action="store_true")
    # free-form, as in the JAX CLI: the model raises on a value it lacks
    p.add_argument("--grad_method", default="detach")
    p.add_argument("--agg_mode", default="adaptive")
    p.add_argument("--use_fmt", action="store_true")
    p.add_argument("--no_geo_fusion", action="store_true")
    p.add_argument("--dtype", default="auto", choices=["auto", "bf16", "f32"],
                   help="compute dtype: auto = bf16 on CUDA, f32 elsewhere")
    p.add_argument("--no_clamp_samples", action="store_true",
                   help="do not clamp the ADIA hypotheses into the input sweep range")
    p.add_argument("--sampler", default="auto", choices=["auto", "pallas", "xla"],
                   help=f"{_NO_EFFECT}: the kernels gather every tap")
    p.add_argument("--sampler_windows", default="dtu", choices=["dtu", "single", "default"],
                   help=f"{_NO_EFFECT}: the kernels have no window budgets")
    p.add_argument("--cache_dir", default="~/.cache/jax_damvsnet",
                   help=f"{_NO_EFFECT}: there is no XLA compilation cache")
    p.add_argument("--filter_method", default="dypcd",
                   choices=["pcd", "dypcd", "consistency", "none"])
    p.add_argument("--conf", default="0.1,0.15,0.9")
    p.add_argument("--thres_view", type=int, default=5)
    p.add_argument("--dist_base", type=float, default=0.25)
    p.add_argument("--rel_diff_base", type=float, default=1.0 / 1300)
    p.add_argument("--num_consistent", type=int, default=None,
                   help="consistency filter: fixed gipuma-style vote "
                        "threshold instead of the dynamic dypcd vote")
    p.add_argument("--dist_backend", default=None, choices=["nccl", "gloo"],
                   help="the process group's backend across ranks (default: nccl "
                        "on CUDA, gloo on the CPU)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda, this rank's card; raises "
                        "without one)")
    return p


def load_weights(model, path: str) -> None:
    """A flax flat-path .npz or a port .pt checkpoint (weights only) into
    ``model``; an orbax checkpoint directory raises."""
    from ..train.state import TrainState, restore_checkpoint
    from ..utils.weights import load_bench_weights

    if os.path.isdir(path):
        raise ValueError(f"--loadckpt {path}: a directory (an orbax checkpoint of the JAX "
                         "package); convert it to a flat .npz with "
                         "scripts/export_bench_weights.py")
    if path.endswith(".npz"):
        load_bench_weights(model, path)
    else:
        restore_checkpoint(path, TrainState(model, None), weights_only=True)


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from ..data import find_dataset_def
    from ..infer.fusion_dypcd import dypcd_filter
    from ..infer.fusion_pcd import pcd_filter
    from ..infer.runner import DepthRunner, save_scene_depth
    from ..model import CascadeMVSNet
    from ..parallel import local_device, maybe_initialize_distributed, shard_work_items

    rank, world = maybe_initialize_distributed(args.dist_backend, args.device)
    device = local_device(args.device)
    with open(args.testlist) as f:
        testlist = [line.rstrip() for line in f if line.strip()]
    # scan-parallel: each rank takes a disjoint slice of the scenes; the
    # outputs land in the shared outdir
    testlist = shard_work_items(testlist, rank, world)
    if world > 1:
        print(f"process {rank}/{world}: {len(testlist)} scenes")
    if args.dtype == "auto":
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    else:
        dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[args.dtype]

    model = CascadeMVSNet(
        ndepths=tuple(int(x) for x in args.ndepths.split(",") if x),
        cr_base_chs=tuple(int(x) for x in args.cr_base_chs.split(",") if x),
        share_cr=args.share_cr, grad_method=args.grad_method, agg_mode=args.agg_mode,
        use_fmt=args.use_fmt, use_geo_fusion=not args.no_geo_fusion, refine=False,
        compute_dtype=dtype, clamp_samples=not args.no_clamp_samples, device=device)
    if args.loadckpt:
        load_weights(model, args.loadckpt)
        print(f"loaded weights from {args.loadckpt}")

    dataset_cls = find_dataset_def(args.dataset)
    conf = tuple(float(x) for x in args.conf.split(","))
    runner = DepthRunner(model, device=device)
    for scene in testlist:
        dataset = dataset_cls(args.testpath, [scene], "test", args.num_view,
                              args.numdepth, args.interval_scale,
                              max_h=args.max_h, max_w=args.max_w, fix_res=args.fix_res)
        save_scene_depth(runner, dataset, args.outdir, batch_size=args.batch_size)

    if args.filter_method == "dypcd":
        dypcd_filter(args.testpath, args.outdir, testlist, conf=conf,
                     dist_base=args.dist_base, rel_diff_base=args.rel_diff_base)
    elif args.filter_method == "pcd":
        pcd_filter(args.testpath, args.outdir, testlist, conf=conf,
                   thres_view=args.thres_view)
    elif args.filter_method == "consistency":
        from ..infer.fusion_device import consistency_filter
        consistency_filter(args.testpath, args.outdir, testlist, conf=conf,
                           dist_base=args.dist_base, rel_diff_base=args.rel_diff_base,
                           num_consistent=args.num_consistent, device=device)
    return runner


if __name__ == "__main__":
    main()
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
