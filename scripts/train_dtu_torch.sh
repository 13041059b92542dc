#!/usr/bin/env bash
# DTU training on the PyTorch/CUDA port: scripts/train_dtu.sh's recipe (16
# epochs, Adam lr 1e-3 warmup 500 it, x0.5 @ 10/12/14, batch 4, N=5,
# D1=192, CPC x12) through damvsnet_tpu_torch.cli.train, on CUDA.
set -eu
DTU_TRAINING=${DTU_TRAINING:-/data/dtu/mvs_training/dtu}
LOG_DIR=${LOG_DIR:-./checkpoints/dtu}
mkdir -p "$LOG_DIR"
python -m damvsnet_tpu_torch.cli.train \
  --dataset dtu_yao \
  --trainpath "$DTU_TRAINING" --trainlist lists/dtu/train.txt \
  --testpath "$DTU_TRAINING" --testlist lists/dtu/val.txt \
  --logdir "$LOG_DIR" \
  --epochs 16 --lr 0.001 --lrepochs "10,12,14:2" \
  --nviews 5 --batch_size 4 --numdepth 192 --interval_scale 1.06 \
  --ndepths "64,32,8" --depth_inter_r "4,2,1" --dlossw "0.5,1.0,2.0" \
  "$@" 2>&1 | tee -a "$LOG_DIR/log.txt"
