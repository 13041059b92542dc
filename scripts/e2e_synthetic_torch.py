"""End-to-end accuracy chain of the PyTorch port on the synthetic scene
family: the port's counterpart of scripts/e2e_synthetic.py, with the same
arguments and defaults but ``--device`` in place of ``--platform``.

  1. export a held-out synthetic scene (seed 10000) in the MVSNet eval
     layout (data/synthetic.py::export_synthetic_scene);
  2. train the cascade from scratch on SyntheticDataset (the shuffling
     loader, seed 1, 2 workers) with the staged smooth-L1 + CPC loss, Adam
     under the warmup-multistep schedule (100 warmup steps, x0.5 at 60 %
     and 80 % of the run), the non-fused training step (the plain warp
     under autograd, the weight nets with batch statistics);
  3. save a checkpoint and restore it weights-only into a model built
     afresh from another seed, and compare every parameter and buffer
     (the BN running statistics included) with the trained model's;
  4. run DepthRunner / save_scene_depth on the held-out scene at batch 1
     (the serving forward: kernels K1 and K2 on the card);
  5. measure the depth error against the analytic depth;
  6. fuse with dypcd (host; needs cv2 and PIL) and with the device
     consistency filter (infer/fusion_device.py) over the same depth files;
  7. score the fused clouds by the DTU protocol (eval/dtu_eval.py: 0.2 mm
     thinning, 20 mm cutoff), one world unit taken as 100 mm.

The model is what the JAX chain builds: ``CascadeMVSNet(ndepths,
agg_mode="adaptive", use_geo_fusion=True, clamp_samples=False,
align_corners=args.align_corners)`` in fp32; with ``--use_fmt`` the same
with the FMT pathway (``use_fmt=True``). ``--init`` starts training from a
flat checkpoint (``load_bench_weights``) in place of the seeded weights;
FMT keeps its seeded start. ``--export`` writes the restored model in that
flat layout (``save_bench_weights``) once training is done, and the report
records its sha256 and which of the model's tensors, if any, training left
at their starting values. One JSON goes to ``--out``
with the JAX chain's keys, plus the card (nvidia-smi's name and power
limit), the median training step's ms, the peak device memory, the kernel
launches of the serving run, the restore's comparison and ``reduced``, the
ways this run differs from the JAX chain's. Where PIL or cv2 is not
installed (a machine without them), every image file goes through
core/imageio.py's numpy stand-in, so the held-out images are not
JPEG-compressed, and dypcd is not run: both are recorded in the JSON and
the DTU score is then the device filter's.

Usage:
    python3 scripts/e2e_synthetic_torch.py --align_corners --epochs 16 --d0 48 \\
        --ndepths 32,16,8 --lr 1e-3 --out ACCURACY_gpu.json          (one GPU)
    python3 scripts/e2e_synthetic_torch.py --use_fmt --init weights/bench_ckpt.npz \\
        --epochs 16 --d0 48 --ndepths 32,16,8 --lr 5e-4 \\
        --export fmt_port.npz --out ACCURACY_fmt.json   (FMT trained by the port)
    python3 scripts/e2e_synthetic_torch.py --device cpu --height 64 --width 64 \\
        --nviews 3 --d0 16 --ndepths 8,8,8 --epochs 3 --epoch_len 24 --out /tmp/e2e.json
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MM_PER_UNIT = 100.0
SCAN = "scan_synth"
HELD_OUT_SEED = 10_000


def parse_args(argv=None):
    p = argparse.ArgumentParser("e2e synthetic accuracy chain (PyTorch port)")
    p.add_argument("--height", type=int, default=128)
    p.add_argument("--width", type=int, default=160)
    p.add_argument("--nviews", type=int, default=5)
    p.add_argument("--d0", type=int, default=48)
    p.add_argument("--ndepths", default="16,8,8")
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--epoch_len", type=int, default=256)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--conf", default="0.1,0.15,0.5",
                   help="photo-mask confidence triplet of both fusion backends")
    p.add_argument("--workdir", default=None)
    p.add_argument("--out", default="ACCURACY_r04.json")
    p.add_argument("--device", default=None,
                   help="cpu to run on the host (default: CUDA, which must be present)")
    p.add_argument("--align_corners", action="store_true",
                   help="sample the cost volume with align_corners=True, as the JAX "
                        "chain's flag does (see scripts/e2e_synthetic.py)")
    p.add_argument("--use_fmt", action="store_true",
                   help="the cascade with the FMT pathway (CascadeMVSNet(use_fmt=True))")
    p.add_argument("--init", default=None,
                   help="a flat .npz (weights/bench_ckpt.npz's layout) to start from; "
                        "FMT keeps its seeded weights")
    p.add_argument("--export", default=None,
                   help="write the trained weights to this .npz in that flat layout")
    return p.parse_args(argv)


def device_name(dev) -> str:
    """The card as nvidia-smi names it, with its power limit; "cpu" on the host."""
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def rounded(d: dict) -> dict:
    return {k: (round(v, 4) if isinstance(v, float) else v) for k, v in d.items()}


def build_model(args, dev, seed):
    import torch
    from damvsnet_tpu_torch.model import CascadeMVSNet
    torch.manual_seed(seed)
    ndepths = tuple(int(x) for x in args.ndepths.split(","))
    return CascadeMVSNet(ndepths=ndepths, compute_dtype=torch.float32, device=dev,
                         agg_mode="adaptive", use_geo_fusion=True, clamp_samples=False,
                         align_corners=args.align_corners, use_fmt=args.use_fmt)


def init_weights(model, path):
    """Load the flat checkpoint into ``model``; an FMT model's FMT keeps its
    seeded weights (weights/bench_ckpt.npz holds none). Returns the modules
    left seeded."""
    from damvsnet_tpu_torch.utils.weights import load_bench_weights
    seeded = ("FMT_with_pathway",) if model.use_fmt else ()
    load_bench_weights(model, path, seeded=seeded)
    return seeded


def make_state(model, args, steps_per_epoch):
    """Adam under the JAX chain's schedule: x0.5 at 60 % and 80 % of the
    run (scripts/e2e_synthetic.py:121-125), 100 warmup steps."""
    from damvsnet_tpu_torch.train.schedule import make_optimizer
    from damvsnet_tpu_torch.train.state import TrainState
    ms = f"{max(1, int(args.epochs * 0.6))},{max(2, int(args.epochs * 0.8))}:2"
    opt, sched = make_optimizer(model.parameters(), args.lr, ms, steps_per_epoch, 0.0,
                                warmup_iters=100)
    return TrainState(model, opt, sched)


def train(args, dev, logdir, report):
    """Steps 2-3. Returns the restored model."""
    import numpy as np
    import torch
    from damvsnet_tpu_torch.data.common import DataLoader
    from damvsnet_tpu_torch.data.synthetic import SyntheticDataset
    from damvsnet_tpu_torch.train.loop import Trainer
    from damvsnet_tpu_torch.train.state import Checkpointer, restore_checkpoint

    model = build_model(args, dev, seed=1)
    if args.init:
        seeded = init_weights(model, args.init)
        report["init"] = {"from": args.init, "seeded": list(seeded)}
    start = {k: v.detach().clone() for k, v in model.state_dict().items()
             if v.dtype.is_floating_point} if args.export else {}
    train_ds = SyntheticDataset(mode="train", nviews=args.nviews, ndepths=args.d0,
                                height=args.height, width=args.width,
                                length=args.epoch_len)
    loader = DataLoader(train_ds, args.batch_size, shuffle=True, seed=1, num_workers=2)
    state = make_state(model, args, len(loader))
    report["n_params"] = sum(p.numel() for p in model.parameters())
    print(f"model: ndepths={model.ndepths}, {report['n_params']:,} params", flush=True)

    trainer = Trainer(state, logdir, use_cpc=True, summary_freq=20, device=dev)
    step_ms, inner = [], trainer.train_step

    def timed_step(state, batch):
        t0 = time.perf_counter()
        metrics = inner(state, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return metrics

    trainer.train_step = timed_step
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses = []
    for epoch in range(args.epochs):
        t0 = time.time()
        means = trainer.train_epoch(loader.iter_epoch(epoch))
        losses.append({k: round(float(v), 5) for k, v in means.items()})
        print(f"epoch {epoch}: {losses[-1]} ({time.time() - t0:.1f}s)", flush=True)
    trainer.close()
    report["train_curve"] = losses
    report["train_steps"] = int(state.step)
    report["train_step_ms_median"] = float(np.median(step_ms))
    report["peak_gib"] = {"train": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                                    if dev.type == "cuda" else None)}

    # weights-only restore (--loadckpt) into a model of another seed
    ckpt_path = Checkpointer(logdir).save(state)
    fresh = build_model(args, dev, seed=2)
    restore_checkpoint(ckpt_path, make_state(fresh, args, len(loader)), weights_only=True)
    trained_sd, restored_sd = model.state_dict(), fresh.state_dict()
    report["checkpoint"] = {
        "tensors": len(restored_sd),
        "restored_bitwise": (trained_sd.keys() == restored_sd.keys() and all(
            torch.equal(trained_sd[k], restored_sd[k]) for k in trained_sd))}
    if args.export:
        from damvsnet_tpu_torch.utils.weights import save_bench_weights
        flat = save_bench_weights(fresh, args.export)
        with open(args.export, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        report["export"] = {"path": args.export, "arrays": len(flat), "sha256": digest,
                            "left_at_start": sorted(k for k, v in start.items()
                                                    if torch.equal(v, trained_sd[k]))}
        print(f"exported {len(flat)} arrays to {args.export} (sha256 {digest})", flush=True)
    return fresh


def serve(args, dev, model, datadir, outdir, report):
    """Steps 4-5: depth files of the held-out scene and their error."""
    import numpy as np
    import torch
    from damvsnet_tpu_torch.core.pfm import read_pfm
    from damvsnet_tpu_torch.data.general_eval import GeneralEvalDataset
    from damvsnet_tpu_torch.infer.runner import DepthRunner, save_scene_depth
    from damvsnet_tpu_torch.ops.kernels import fused_costvol, probstats, sweep_sampler

    counters = (fused_costvol.fused_adaptive_cost_volume, probstats.prob_volume_stats_fused,
                fused_costvol.fused_adaptive_cost_volume_backward,
                sweep_sampler.plane_sweep_sample, sweep_sampler.plane_sweep_variance)
    before = [fn.launches for fn in counters]
    eval_ds = GeneralEvalDataset(datadir, [SCAN], "test", args.nviews, ndepths=args.d0,
                                 interval_scale=1.0, max_h=args.height, max_w=args.width)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    n_views, _, batch_times = save_scene_depth(DepthRunner(model, device=dev), eval_ds,
                                               outdir, batch_size=1)
    steady = sum(batch_times[1:]) / max(1, n_views - 1) if n_views > 1 else batch_times[0]
    report["inference"] = {
        "views": n_views, "sec_per_view": round(steady, 4),
        "first_batch_sec_incl_warmup": round(batch_times[0], 2),
        "launches": {fn.__name__: fn.launches - n for fn, n in zip(counters, before)}}
    report["peak_gib"]["inference"] = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                                       if dev.type == "cuda" else None)

    # the threshold is the stage-1 input sweep interval (d0 steps over the
    # cam file's range), as in the JAX chain
    errs, in1itv = [], []
    interval_mm = (eval_ds[0]["depth_values"][1] - eval_ds[0]["depth_values"][0]) * MM_PER_UNIT
    for v in range(args.nviews):
        est, _ = read_pfm(os.path.join(outdir, SCAN, f"depth_est/{v:08d}.pfm"))
        gt, _ = read_pfm(os.path.join(datadir, SCAN, f"gt_depths/{v:08d}.pfm"))
        e = np.abs(est - gt) * MM_PER_UNIT
        errs.append(float(e.mean()))
        in1itv.append(float((e < interval_mm).mean()))
    report["depth"] = {
        "abs_err_mm_mean": round(float(np.mean(errs)), 4),
        "abs_err_mm_per_view": [round(e, 4) for e in errs],
        "frac_within_1_interval": round(float(np.mean(in1itv)), 4),
        "input_interval_mm": round(float(interval_mm), 4),
        "finite": bool(all(np.isfinite(e) for e in errs)),
    }
    print(f"depth abs err: {report['depth']['abs_err_mm_mean']} mm, "
          f"{report['depth']['frac_within_1_interval']} within one input interval "
          f"({report['depth']['input_interval_mm']} mm)", flush=True)


def fuse_and_score(args, dev, datadir, outdir, missing, report):
    """Steps 6-7: both fusion backends over the same depth files, each cloud
    scored. ``missing``: the codec packages that do not import (dypcd
    needs both)."""
    import numpy as np
    from damvsnet_tpu_torch.core.ply import read_ply
    from damvsnet_tpu_torch.eval.dtu_eval import evaluate_scan
    from damvsnet_tpu_torch.infer.fusion_device import consistency_filter
    from damvsnet_tpu_torch.infer.fusion_dypcd import dypcd_filter

    conf = tuple(float(x) for x in args.conf.split(","))
    ply_path = os.path.join(outdir, f"{SCAN}.ply")
    gt_pts = np.load(os.path.join(datadir, SCAN, "gt_points.npy")).astype(np.float64)

    def score(pts):
        return rounded(evaluate_scan(pts.astype(np.float64) * MM_PER_UNIT,
                                     gt_pts * MM_PER_UNIT, dst=0.2, max_dist=20.0))

    consistency_filter(datadir, outdir, [SCAN], conf=conf, device=dev)
    device_pts, _ = read_ply(ply_path)
    os.replace(ply_path, ply_path + ".device")
    report["dtu_protocol_device_backend"] = score(device_pts)
    report["fusion"] = {"points_device_backend": int(len(device_pts))}
    if missing:
        report["fusion"]["dypcd"] = f"not run: no {' or '.join(missing)}"
        report["fusion"]["points"] = int(len(device_pts))
        report["dtu_protocol"] = dict(report["dtu_protocol_device_backend"],
                                      backend="device")
    else:
        dypcd_filter(datadir, outdir, [SCAN], conf=conf)
        pts, _ = read_ply(ply_path)
        report["fusion"]["dypcd"] = "run"
        report["fusion"]["points"] = int(len(pts))
        report["dtu_protocol"] = dict(score(pts), backend="dypcd")
    r, rd = report["dtu_protocol"], report["dtu_protocol_device_backend"]
    print(f"fused {report['fusion']['points']} pts ({r['backend']}) | acc={r['acc']} mm "
          f"comp={r['comp']} mm overall={r['overall']} mm | device backend "
          f"{len(device_pts)} pts overall={rd['overall']}", flush=True)


def main(argv=None):
    args = parse_args(argv)
    import torch
    from damvsnet_tpu_torch.core import imageio
    from damvsnet_tpu_torch.data.synthetic import export_synthetic_scene
    from damvsnet_tpu_torch.utils.device import resolve_device

    t_start = time.time()
    dev = resolve_device(args.device)
    workdir = args.workdir or tempfile.mkdtemp(prefix="e2e_synth_torch_")
    datadir, outdir = os.path.join(workdir, "data"), os.path.join(workdir, "outputs")
    logdir = os.path.join(workdir, "ckpt")
    os.makedirs(logdir, exist_ok=True)
    report = {"config": vars(args).copy(), "workdir": workdir, "device": device_name(dev),
              "reduced": []}
    # the convolutions' fp32: cuDNN may round their inputs to TF32 (torch's default)
    report["config"]["cudnn_allow_tf32"] = (torch.backends.cudnn.allow_tf32
                                            if dev.type == "cuda" else None)
    print(f"workdir={workdir} device={report['device']}", flush=True)

    missing = imageio.codecs_missing()
    codec = contextlib.nullcontext()
    if missing:
        codec = imageio.numpy_codec()
        report["reduced"].append(
            f"image files as raw arrays through core/imageio.py's numpy stand-in "
            f"({' and '.join(missing)} not installed): the held-out scene's images are "
            "not JPEG-compressed, where the JAX chain's are (quality 100, 4:4:4)")
        report["reduced"].append(f"dypcd not run ({' and '.join(missing)} not installed): "
                                 "dtu_protocol is the device consistency filter's cloud")
        print(f"image codec: numpy stand-in ({', '.join(missing)} not installed)", flush=True)
    # on the CPU, oneDNN's convolution backward corrupted the heap at the
    # cascade's small training shapes; torch's own CPU convolutions run instead
    cpu_convs = torch.backends.mkldnn.flags(enabled=dev.type != "cpu")
    with codec, cpu_convs:
        export_synthetic_scene(datadir, SCAN, height=args.height, width=args.width,
                               nviews=args.nviews, seed=HELD_OUT_SEED)
        restored = train(args, dev, logdir, report)
        serve(args, dev, restored, datadir, outdir, report)
        fuse_and_score(args, dev, datadir, outdir, missing, report)
    report["elapsed_sec"] = round(time.time() - t_start, 1)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {args.out} in {report['elapsed_sec']}s", flush=True)
    return report


if __name__ == "__main__":
    main()
