"""Training CLI; counterpart of damvsnet_tpu/cli/train.py (flag surface of
the reference train.py:19-77; every flag of the JAX CLI parses here, with
its choices and default).

    python -m damvsnet_tpu_torch.cli.train --dataset dtu_yao \
        --trainpath <dtu_training> --trainlist lists/dtu/train.txt \
        --logdir ./checkpoints --epochs 16 --batch_size 4 --nviews 5 \
        --numdepth 192 --loadckpt weights/bench_ckpt.npz

It builds what the JAX CLI builds from the same flags: fpn, adaptive or
variance aggregation (``--agg_mode``), the handoff ``--grad_method``
(detach, or undetach), the FMT pathway with ``--use_fmt``, geo fusion
unless ``--no_geo_fusion``, U-Net widths ``--cr_base_chs``
(``--share_cr`` raises in both packages: one regularizer cannot take the
stages' three widths). By default the cost
volume trains through the plain warp with the weight net's batch
statistics and unclamped hypotheses; ``--fused_train`` trains the adaptive
cost volume through the fused kernels (K1 with its backward K3 on the
card) with the folded weight net and clamped hypotheses. The DTU and
BlendedMVS loaders need cv2 and PIL. It runs on CUDA, or on the device
``--device`` names. ``--profile_dir`` traces 1 warm and 5 traced steps
with torch.profiler (one trace per rank) before the epochs.

Across ranks, started by a launcher that sets torchrun's environment:

    torchrun --nproc_per_node=<cards> -m damvsnet_tpu_torch.cli.train ...

each rank trains on its card (``LOCAL_RANK``) its rows of the global
``--batch_size`` batch (NCCL by default, ``--dist_backend gloo`` where
ranks share a card or run on the CPU). ``--debug_nans`` runs with
torch's anomaly detection on (JAX's jax_debug_nans, whose help names it as
the analog): a NaN out of a backward raises, naming its function. ``--mode``
takes JAX's choices and, as there, is never read; ``--cache_dir`` names
JAX's XLA compilation cache and has no effect. The ranks form a (data, space)
mesh, data-major: ``--mesh_space S`` cuts every stage's depth hypotheses
into S slabs over the ranks of a space group, which take the same rows
(the depth-slab axis, ``parallel/slab.py``); ``--mesh_data`` (default:
the ranks over S) splits the batch, and ``--mesh_data x --mesh_space``
must be the number of ranks.
"""
from __future__ import annotations

import argparse
import contextlib
import time

_NO_EFFECT = "accepted for the JAX CLI's command lines; no effect in the port"


def build_parser():
    p = argparse.ArgumentParser("damvsnet-tpu-torch train")
    p.add_argument("--mode", default="train", choices=["train", "test", "profile"],
                   help=f"{_NO_EFFECT}: never read, as in the JAX CLI")
    p.add_argument("--model", default="mvsnet")
    p.add_argument("--dataset", default="dtu_yao")
    p.add_argument("--trainpath", default=None)
    p.add_argument("--testpath", default=None)
    p.add_argument("--trainlist", default=None)
    p.add_argument("--testlist", default=None)
    p.add_argument("--epochs", type=int, default=16)
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--lrepochs", default="10,12,14:2")
    p.add_argument("--wd", type=float, default=0.0)
    p.add_argument("--nviews", type=int, default=5)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--numdepth", type=int, default=192)
    p.add_argument("--interval_scale", type=float, default=1.06)
    p.add_argument("--summary_freq", type=int, default=50)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--logdir", default="./checkpoints")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--loadckpt", default=None,
                   help="weights only: a checkpoint of this CLI (.pt) or a "
                        "flax flat-path .npz such as weights/bench_ckpt.npz")
    p.add_argument("--ndepths", default="64,32,8")
    p.add_argument("--depth_inter_r", default="4,2,1")
    p.add_argument("--cr_base_chs", default="8,8,8")
    p.add_argument("--dlossw", default="0.5,1.0,2.0")
    p.add_argument("--share_cr", action="store_true")
    p.add_argument("--grad_method", default="detach", choices=["detach", "undetach"])
    p.add_argument("--agg_mode", default="adaptive", choices=["adaptive", "variance"])
    p.add_argument("--use_fmt", action="store_true")
    p.add_argument("--no_geo_fusion", action="store_true")
    p.add_argument("--no_cpc", action="store_true")
    p.add_argument("--dtype", default="auto", choices=["auto", "bf16", "f32"],
                   help="compute dtype: auto = bf16 on CUDA, f32 elsewhere")
    p.add_argument("--fused_train", action="store_true",
                   help="train the adaptive cost volume through the fused "
                        "kernels (K1, backward K3) with the folded weight "
                        "net (its BNs on running statistics) and clamped "
                        "hypotheses; default: the plain warp, the weight "
                        "net's batch statistics, unclamped hypotheses")
    p.add_argument("--cache_dir", default="~/.cache/jax_damvsnet",
                   help=f"{_NO_EFFECT}: there is no XLA compilation cache")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--grad_accum", type=int, default=1)
    p.add_argument("--save_freq", type=int, default=0,
                   help="a mid-epoch checkpoint (with the data cursor) every "
                        "N steps; --resume continues from it mid-epoch. "
                        "0 = per-epoch only (reference parity)")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace of 5 steps after 1 warm "
                        "step here, one file per rank")
    p.add_argument("--mesh_data", type=int, default=None,
                   help="data-parallel ranks, each its rows of the batch (default: "
                        "the ranks over --mesh_space)")
    p.add_argument("--mesh_space", type=int, default=1,
                   help="'space' mesh axis size: every stage's depth hypotheses cut "
                        "into this many slabs over the ranks of a space group")
    p.add_argument("--dist_backend", default=None, choices=["nccl", "gloo"],
                   help="the process group's backend (default: nccl on CUDA, gloo "
                        "on the CPU); NCCL puts at most one rank on a card")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda, this rank's card; raises "
                        "without one)")
    p.add_argument("--debug_nans", action="store_true",
                   help="run with torch.autograd's anomaly detection (JAX: "
                        "jax_debug_nans): a NaN out of a backward raises")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch
    with (torch.autograd.set_detect_anomaly(True) if args.debug_nans
          else contextlib.nullcontext()):
        return train(args)


def train(args):
    """The run ``main`` parses for."""
    import torch

    from ..data import find_dataset_def
    from ..data.common import DataLoader
    from ..model import CascadeMVSNet
    from ..parallel import local_device, make_mesh, maybe_initialize_distributed
    from ..train.loop import Trainer
    from ..train.profiler import trace_path, trace_steps
    from ..train.schedule import make_optimizer
    from ..train.state import TrainState, latest_checkpoint, restore_checkpoint
    from ..utils.weights import load_bench_weights

    rank, _ = maybe_initialize_distributed(args.dist_backend, args.device)
    log = print if rank == 0 else (lambda *_: None)  # rank 0 alone writes the log
    mesh = make_mesh(data=args.mesh_data, space=args.mesh_space)
    dataset_cls = find_dataset_def(args.dataset)
    device = local_device(args.device)
    torch.manual_seed(args.seed)
    ndepths = tuple(int(x) for x in args.ndepths.split(",") if x)
    dlossw = tuple(float(x) for x in args.dlossw.split(",") if x)
    if args.dtype == "auto":
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    else:
        dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[args.dtype]
    cr_base_chs = tuple(int(x) for x in args.cr_base_chs.split(",") if x)
    model = CascadeMVSNet(ndepths=ndepths, compute_dtype=dtype, device=device,
                          depth_intervals_ratio=tuple(
                              float(x) for x in args.depth_inter_r.split(",") if x),
                          agg_mode=args.agg_mode, share_cr=args.share_cr,
                          grad_method=args.grad_method, use_fmt=args.use_fmt,
                          use_geo_fusion=not args.no_geo_fusion, cr_base_chs=cr_base_chs,
                          fused_train=args.fused_train,
                          clamp_samples=args.fused_train, slab_group=mesh.space_group,
                          slab_stats_group=mesh.slab_stats_group)

    train_dataset = dataset_cls(args.trainpath, args.trainlist, "train",
                                args.nviews, args.numdepth, args.interval_scale)
    val_dataset = (dataset_cls(args.testpath or args.trainpath,
                               args.testlist or args.trainlist, "val",
                               args.nviews, args.numdepth, args.interval_scale)
                   if args.testlist else None)
    shard = {"rank": mesh.data_rank, "world": mesh.data}
    train_loader = DataLoader(train_dataset, args.batch_size, shuffle=True,
                              seed=args.seed, num_workers=args.num_workers,
                              grad_accum=args.grad_accum, **shard)
    optimizer, scheduler = make_optimizer(model.parameters(), args.lr, args.lrepochs,
                                          len(train_loader), args.wd)
    state = TrainState(model, optimizer, scheduler)

    first_batch = 0
    if args.resume:
        ckpt = latest_checkpoint(args.logdir)
        if ckpt:
            state, first_batch = restore_checkpoint(ckpt, state)
            log(f"resumed from {ckpt} at epoch {state.epoch}"
                  + (f" (mid-epoch, from batch {first_batch})" if first_batch else ""))
    elif args.loadckpt:
        if args.loadckpt.endswith(".npz"):
            load_bench_weights(model, args.loadckpt)
        else:
            restore_checkpoint(args.loadckpt, state, weights_only=True)
        log(f"loaded weights from {args.loadckpt}")

    trainer = Trainer(state, args.logdir, dlossw=dlossw, use_cpc=not args.no_cpc,
                      summary_freq=args.summary_freq, save_freq=args.save_freq,
                      grad_accum=args.grad_accum, device=device, mesh=mesh)
    if args.profile_dir:
        # the JAX CLI's profile: one warm step, then 5 traced steps, on the
        # epoch's first batch; they train (damvsnet_tpu/cli/train.py:177-186)
        warm = next(train_loader.iter_epoch(state.epoch, skip=first_batch))
        trainer.train_step(state, warm)
        with trace_steps(args.profile_dir):
            for _ in range(5):
                trainer.train_step(state, warm)
        log(f"profiler traces written to {args.profile_dir}, one a rank "
            f"(this rank's: {trace_path(args.profile_dir)})")
    for epoch in range(state.epoch, args.epochs):
        t0 = time.time()
        # the loader's order is named by the epoch, so a resumed run sees
        # the interrupted run's batches
        means = trainer.train_epoch(train_loader.iter_epoch(epoch, skip=first_batch),
                                    first_batch=first_batch)
        first_batch = 0
        log(f"epoch {epoch} done in {time.time() - t0:.1f}s: "
              + " ".join(f"{k}={v:.4f}" for k, v in means.items()))
        if val_dataset is not None:
            val_loader = DataLoader(val_dataset, args.batch_size,
                                    num_workers=args.num_workers, **shard)
            trainer.eval_epoch(val_loader.iter_epoch(0))
    trainer.close()
    return trainer


if __name__ == "__main__":
    main()
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
