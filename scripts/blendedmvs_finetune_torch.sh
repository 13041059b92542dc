#!/usr/bin/env bash
# BlendedMVS fine-tune from a DTU checkpoint on the PyTorch/CUDA port:
# scripts/blendedmvs_finetune.sh's recipe (batch 2, N=7, numdepth 128)
# through damvsnet_tpu_torch.cli.train, on CUDA, from the port's DTU
# checkpoint (.pt).
set -eu
BLD_PATH=${BLD_PATH:-/data/blendedmvs/dataset_low_res}
DTU_CKPT=${DTU_CKPT:-./checkpoints/dtu/ckpt_000015.pt}
LOG_DIR=${LOG_DIR:-./checkpoints/blendedmvs}
mkdir -p "$LOG_DIR"
python -m damvsnet_tpu_torch.cli.train \
  --dataset blendedmvs \
  --trainpath "$BLD_PATH" --trainlist lists/blendedmvs/training_list.txt \
  --testpath "$BLD_PATH" --testlist lists/blendedmvs/validation_list.txt \
  --logdir "$LOG_DIR" --loadckpt "$DTU_CKPT" \
  --epochs 10 --lr 0.0001 --lrepochs "6,8:2" \
  --nviews 7 --batch_size 2 --numdepth 128 --interval_scale 1.06 \
  --ndepths "64,32,8" --dlossw "0.5,1.0,2.0" \
  "$@" 2>&1 | tee -a "$LOG_DIR/log.txt"
