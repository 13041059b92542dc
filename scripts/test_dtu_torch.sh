#!/usr/bin/env bash
# DTU test inference + dypcd fusion on the PyTorch/CUDA port:
# scripts/test_dtu.sh's recipe (1152x864, N=5, conf 0.1/0.15/0.9, dist_base
# 1/4, rel_diff_base 1/1300) through damvsnet_tpu_torch.cli.test, on CUDA.
# The checkpoint is the port's training CLI's (.pt) or a flat .npz
# (scripts/export_bench_weights.py converts an orbax directory).
set -eu
DTU_TESTPATH=${DTU_TESTPATH:-/data/dtu/dtu_test}
CKPT=${CKPT:-./checkpoints/dtu/ckpt_000015.pt}
OUTDIR=${OUTDIR:-./outputs/dtu}
mkdir -p "$OUTDIR"
python -m damvsnet_tpu_torch.cli.test \
  --dataset general_eval \
  --testpath "$DTU_TESTPATH" --testlist lists/dtu/test.txt \
  --loadckpt "$CKPT" --outdir "$OUTDIR" \
  --numdepth 192 --interval_scale 1.06 --num_view 5 \
  --max_h 864 --max_w 1152 \
  --ndepths "64,32,8" --filter_method dypcd --conf "0.1,0.15,0.9" \
  "$@" 2>&1 | tee -a "$OUTDIR/log.txt"
