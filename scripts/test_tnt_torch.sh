#!/usr/bin/env bash
# Tanks-and-Temples inference + dypcd fusion with per-scene confidences on
# the PyTorch/CUDA port: scripts/test_tnt.sh's recipe (native resolution
# snapped to x32, 1920x1056 for most scenes, N=11) through
# damvsnet_tpu_torch.cli.test, on CUDA. The checkpoint is the port's
# training CLI's (.pt) or a flat .npz.
set -eu
TNT_TESTPATH=${TNT_TESTPATH:-/data/tnt/intermediate}
TNT_LIST=${TNT_LIST:-lists/tnt/intermediate.txt}
CKPT=${CKPT:-./checkpoints/blendedmvs/ckpt_000015.pt}
OUTDIR=${OUTDIR:-./outputs/tnt}
mkdir -p "$OUTDIR"
python -m damvsnet_tpu_torch.cli.test \
  --dataset tnt_eval_trans \
  --testpath "$TNT_TESTPATH" --testlist "$TNT_LIST" \
  --loadckpt "$CKPT" --outdir "$OUTDIR" \
  --numdepth 192 --interval_scale 1.0 --num_view 11 \
  --max_h 1080 --max_w 2048 \
  --ndepths "64,32,8" --filter_method dypcd \
  "$@" 2>&1 | tee -a "$OUTDIR/log.txt"
