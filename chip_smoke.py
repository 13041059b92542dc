"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        (from the repository root; needs one card)

Phases, in order; any failure propagates and the script exits non-zero
without printing its result line:

  1. the card (name and power limit from nvidia-smi), torch and CUDA versions;
  2. build the CUDA kernels from damvsnet_tpu_torch/ops/kernels/csrc
     (one nvcc per source, started together) and print their register use;
  3. K1, the fused adaptive cost volume, against its plain PyTorch version
     at each stage's full-width serving shape, fp32 (TF32 off) and bf16;
     timed with CUDA events around the wrapper and, device time alone
     (kernel_ms), with torch.profiler; then at a small shape with 17
     source views (two launches, 8 + 9 views, summed) against the plain
     version, forward and, through autograd (K3), the features' gradients;
     each stage's shapes also with the grid un-normalized
     ``align_corners=True`` (the accuracy chain's), against the plain
     version in both dtypes, untimed;
  4. K2, the probability-volume statistics, likewise, on an fp32 cost and
     on a bf16 cost (the bf16 cascade hands K2 the regularizer's bf16
     output, which the kernel reads as it is);
  4b. K5, CostRegNet's Cout=1 prob conv, at each serving stage's shape
     with its trained weight on a channels_last_3d volume, fp32 (TF32 off)
     and bf16, against F.conv3d in fp32; in bf16 timed beside its plain
     version (the library convolution, cuDNN as the port ran it), cuDNN
     with ``cudnn.benchmark``, and cuDNN on the weight zero-padded to 8 and
     16 output channels;
  5. the serving cascade (1152x864, N=5, ndepths 64/32/8, bf16, the
     trained weights of weights/bench_ckpt.npz) answering 3 requests
     through DepthRunner, with every launch counter set to 0 just before
     and read just after; then the same forward on the plain versions in
     bf16 and, with TF32 off, in fp32;
  6. K3, the backward of K1, against torch autograd of K1's plain version
     at each stage's full-width training shape (B=4, 512x640, N=5), fp32
     (TF32 off) and bf16, on the scenes' FeatureNet maps, the trained
     weight net and a seeded cotangent; K1 is timed at the same shapes
     (both also device time alone); each stage also with
     ``align_corners=True``, untimed;
  7. the training step (512x640, B=4, N=5, D0=192, ndepths 64/32/8, bf16,
     the trained weights, Adam under the warmup schedule, CPC on): 1 warm
     step, then 3 timed steps through make_train_step with every launch
     counter set to 0 just before and read just after (K1 and K3 3 times a
     step, K2 never; the weight nets' running statistics do not move,
     ``fused_train=True``); one more step under torch.profiler, for K1's and K3's
     device time per stage at the hypotheses the step itself makes (ADIA's
     at stages 2 and 3); then one batch's loss and gradients on the
     kernels against the plain versions, in fp32 with TF32 off;
  8. K4, the plane-sweep sampler, against its plain version at each
     stage's full-width serving shape for every source view, fp32 (TF32
     off) and bf16, on the scene's FeatureNet maps and sweeps; timed beside
     F.grid_sample on the same normalized grid (the reference's own call),
     with CUDA events and, device time alone, with torch.profiler; then
     K4's variance entry at the same shapes against the plain variance cost
     volume, timed beside the route it replaced (the sampler once per view
     and the eager fp32 sums); then the variance entry at a small shape
     with 17 source views (past one launch's 16: the sampler once per
     view under the same variance) against the plain version;
  9. the variance-aggregation serving cascade (as phase 5, agg_mode
     "variance", the trained weights less the weight nets): 1 warm-up and
     3 timed requests through DepthRunner with every launch counter set to
     0 just before and read just after (K4's variance entry and K2 once a
     stage, K4's sampler and K1 never); the depth against the plain
     versions in bf16 and, with TF32 off, in fp32; then the same without
     geo fusion;
 10. the non-fused adaptive training step, the JAX CLI's default (phase
     7's geometry, weights, optimizer and loss, ``fused_train=False``,
     ``clamp_samples=False``: the plain warp under autograd, the weight
     nets with batch-statistics BN): 1 warm step, then 3 timed steps with
     every launch counter set to 0 just before and read just after (every
     kernel 0 times); the weight nets' 12 running-statistics tensors move;
 11. the variance training step (as phase 10, agg_mode "variance", the
     weights less the weight nets): 1 warm and 2 timed steps, every kernel
     counter 0;
 12. one non-fused step's loss and gradients on the card against the same
     step on the CPU (fp32, TF32 off; oneDNN off on the CPU, as the CPU
     training tests run), adaptive and variance, at B=1, N=3, 64x64,
     ndepths 8/8/8: the CPU step is the one the CPU tests hold against the
     JAX package;
 13. the test CLI (python -m damvsnet_tpu_torch.cli.test) on a synthetic
     scene it first writes in the eval layout (1152x864, 7 views, each a
     reference with the other 6 in pair.txt, num_depth 192): general_eval,
     N=5, ndepths 64/32/8, bf16, the trained weights, the consistency
     filter on the card, with every launch counter set to 0 just before and
     read just after (K1 and K2 3 times a view, K3 and K4 never). The
     image files go through a numpy stand-in for the codec module
     (core/imageio.py), printed as such: the card's machine has no PIL or
     cv2. Then every depth file against its stage's size, every confidence
     in [0, 1], the device fusion on the card against the same on the CPU,
     and the fused cloud scored against the scene's ground truth by the
     DTU protocol (a record, not a gate);
 14. FMT serving: phase 5's request with ``use_fmt`` (the trained weights
     and a seeded FMT pathway, printed as such): 1 warm-up and 3 timed
     requests with every launch counter set to 0 just before and read just
     after (K1 and K2 3 times a request, K3 and K4 never); the depth against
     the plain versions in bf16 and, with TF32 off, in fp32 (bf16: at the
     larger of phase 5's limit and 1.5 times the route's own move under
     one-ulp changes of the camera matrices, see BF16_FLOOR_FACTOR); the FMT
     pathway's own device time and kernel launches (torch.profiler) beside
     the request's;
 15. variant training: phase 7's step with ``use_fmt`` and
     ``grad_method="undetach"`` (``fused_train``, the clamp on, as the CLI
     builds it; the trained weights and a seeded FMT pathway): 1 warm and 2
     timed steps with the counters (K1 and K3 3 times a step, K2 never);
     one batch's loss and gradients on the kernels against the plain
     versions in fp32 with TF32 off; the same step detached, whose stage-1
     gradients must differ;
 16. GeoReg / refine / U-Net serving (``reg_mode="georeg"``, ``refine``,
     ``arch_mode="unet"``; the trained geo fusion and weight nets, the
     FeatureNet, GeoRegNet2d and RefineNet seeded): 1 warm-up and 3 timed
     requests with the counters (K1 and K2 3 times a request); ``depth``
     and ``refined_depth`` against the plain versions in fp32 (TF32 off)
     at GEOREG_FP32_TOL and in bf16 at the larger of phase 5's limit and 1.5
     times the plain route's move under one-ulp changes of its cost
     volumes (GEOREG_BF16_FLOOR), with a planted fault (stage 2's depth
     regressed against its hypotheses read one off) that must exceed the
     bf16 limit and the fp32 one; the peak memory.

 17. data-parallel fused training: phase 7's step on 2 ranks (processes of
     this script with torchrun's environment, gloo over CUDA tensors on the
     one card: NCCL puts at most one rank on a card), global B=4, 2 rows a
     rank: 1 warm and 3 timed steps, every counter set to 0 just before and
     read just after in each rank (K1 and K3 3 times a step in each), one
     more step profiled for its collectives; then one fp32 step (TF32 off)
     of the two ranks against the one-process B=4 step on the same batch,
     on the kernels (loss at STEP_LOSS_RTOL, gradient relative L2 at
     STEP_GRAD_L2, running statistics at DDP_STATS_RTOL) and on their plain
     versions (loss and gradient at the same limits: the ranks' K1 and K3
     launches at 2 rows a rank held against the plain route); then one
     fused step under NCCL, the
     default backend, at world size 1;
 18. the training CLI on 2 ranks (``--dataset synthetic --fused_train``,
     128x160, one epoch of 2 global batches, ``--profile_dir``): one
     checkpoint (rank 0's), one event file whose records and CRCs parse,
     one profiler trace per rank; then a 1-rank ``--resume`` from it;
 19. the scan-parallel test CLI: 2 ranks over 2 scenes at phase 13's flags
     (each rank one scene, K1 and K2 3 times a view), ownership disjoint and
     complete, the depth and confidence files against one process over the
     same scenes (bitwise, or the depth's p999 within phase 5's limit);
 20. FMT serving with sequence parallelism: phase 14's request on 2 ranks,
     31,104 of the 62,208 stage-1 tokens each: 1 warm-up and 3 timed
     requests with the counters (K1 and K2 3 times a request in each rank),
     one more profiled for its collectives; the depth against the
     one-process forward at phase 14's limit in bf16 and FMT_SP_FP32_TOL in
     fp32, and a control that must fail that fp32 limit: the request with
     the attention's all-reduce left out.

The two ranks share the card's SMs and gloo copies every collective
through the host: their times record the paths, not a scaling.

 21. slab serving: phase 5's request (and one variance request) with
     every stage's depth hypotheses cut over 2 ranks (``slab_group``,
     parallel/slab.py): 1 warm-up and 3 timed requests with the counters,
     K1 (or K4's variance entry) once a stage on D/2 hypotheses and K2 once
     a stage on the gathered D (the depth of every call recorded), each
     CostRegNet level's local D by the rule, the stage handoffs bitwise
     equal across the ranks; the depth against the one-process forward in
     bf16 at phase 5's limit and in fp32 (TF32 off) at SLAB_FP32_TOL, and
     a control that must fail that limit: the halos zeroed;
 22. slab training: (a) phase 7's fused step with the hypotheses cut over
     2 ranks (K1 and K3 on D/2, 3 times a step; one more step profiled for
     its collectives and halo exchanges), the parameters equal across the
     ranks, then one fp32 step against the one-process step (loss at
     STEP_LOSS_RTOL, gradient relative L2 at STEP_GRAD_L2, running
     statistics at DDP_STATS_RTOL) and a control that must fail the
     gradient limit: the slab shares' space sum left out; (b) the
     non-fused step (the JAX CLI's default) over 2 ranks, 1 warm and 1
     timed step, its peak per rank beside phase 10's in one process, one
     more step profiled (device time, top kernels, collectives); (c)
     the fused step on the 2x2 mesh (4 ranks, 2 rows a data rank, DDP over
     each column), in fp32 against one process at (a)'s limits;
 23. the training CLI with ``--mesh_data 2 --mesh_space 2`` (4 ranks) at
     phase 18's 128x160: its steps, one checkpoint, then a 1-rank
     ``--resume`` from it.

 24. the Tanks-and-Temples recipe: scripts/test_tnt_torch.sh's argv (taken
     by running the script with a stub ``python`` first on PATH, see
     ``recipe_argv``) with ``--filter_method consistency``, run in-process
     under phase 13's numpy codec on a synthetic ``Family`` scene (1920x1056,
     Family's 1920x1080 snapped to x32, written at that size: the one cut,
     so the loader's cv2.resize is not reached; 11 views, each a reference
     with the other 10 as sources; ndepths 64/32/8, --numdepth 192,
     --interval_scale 1.0, bf16, the trained weights), with every launch
     counter set to 0 just before and read just after (K1 and K2 3 times a
     view, K3 and K4 never); every depth and confidence file at its size
     and finite, the fused cloud not empty, the first view's depth file
     against the plain route (bf16 at phase 5's limit, fp32 at
     TNT_FP32_TOL with TF32 off) and the device fusion on the card against
     the CPU at phase 13's limits (all 11 references on the card, the
     first TNT_CPU_REFS on the CPU too).
 25. the accuracy chain: scripts/e2e_synthetic_torch.py's ``main`` in this
     process at its headline configuration (CHAIN_ARGV: 128x160, N=5, d0
     48, ndepths 32/16/8, B=2, lr 1e-3, align_corners, fp32) for 2 epochs
     of 128 steps (where PIL or cv2 does not import, the script swaps in
     its numpy codec and skips dypcd): training from scratch (the
     non-fused step), the weights-only restore into a model of another
     seed, the held-out scene served through DepthRunner, the device
     consistency filter and the DTU protocol, with every launch counter
     set to 0 just before and read just after (K1 and K2 3 times a view,
     K3 and K4 never: non-fused training launches no kernel); the second
     epoch's mean loss at most CHAIN_LOSS_DROP of the first's, the restore
     bitwise, the depth finite, the cloud not empty.

``share_cr`` builds in neither package (one regularizer cannot take the
stages' three widths), so no phase runs it.

Times come from CUDA events after warm-up (kernels) or from the host clock
around synchronised work (requests, steps). Each bound is the larger of
the bytes the function must move over 3.35 TB/s and its fp32 operations
over 67 TFLOP/s (H100 SXM data sheet), computed from this run's shapes.
The last two lines are the kernels' JSON summary and the device line.
"""
from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
HEIGHT, WIDTH, NVIEWS, D0, SEED = 864, 1152, 5, 192, 3
NDEPTHS = (64, 32, 8)
STAGE_C = (32, 16, 8)
REQUESTS = 3
SERVING_WEIGHTS = "weights/bench_ckpt.npz"
# phases 3 and 8 past one launch's 16 source views (ops/kernels/_common.py)
MANY_VIEWS, MANY_H, MANY_W = 17, 128, 160
# phase 13: the synthetic scene in the eval layout and the CLI's flags
# (scripts/test_dtu.sh's, with the consistency filter); the photo-mask
# triplet is scripts/e2e_synthetic.py's (these weights' final confidence
# sits near 0.5 on the synthetic scenes, under the DTU default's 0.9);
# the DTU protocol's units: 100 mm per world unit, as e2e_synthetic.py
EVAL_VIEWS, EVAL_CONF, MM_PER_UNIT = 7, "0.1,0.15,0.5", 100.0
# phase 24: scripts/test_tnt_torch.sh on a synthetic Tanks-and-Temples
# scene: Family's native 1920x1080 (data/tnt_eval.py::IMAGE_SIZES) snaps to
# 1920x1056, 11 views (each a reference with the other 10 as sources); the
# fp32 depth against the plain route, p999 of |difference|, beside phase 5's
# bf16 limit
TNT_SCENE, TNT_VIEWS, TNT_H, TNT_W, TNT_NATIVE_H = "Family", 11, 1056, 1920, 1080
TNT_FP32_TOL = 1e-3
# the device fusion on the card against the CPU (fusion_card_vs_cpu): the
# share of pixels whose votes differ, and depth_avg's relative error on
# every pixel both accept. A pixel both accept is excused from the depth
# limit, and counted as a differing vote, only where every source whose
# final vote differs between the devices lies within FUSION_MARGIN_ULPS
# fp32 ulps of a threshold on the CPU: its reprojection distance within
# that many ulps of the larger pixel coordinate, or |reprojected -
# reference depth| within that many ulps of the reference depth (the
# quantities that round; an ulp of the threshold itself is finer than one
# rounding of either). One source's flip there moves depth_avg by up to the
# relative-depth threshold over the number of views.
FUSION_MASK_SHARE, FUSION_DEPTH_RTOL, FUSION_MARGIN_ULPS = 1e-3, 1e-5, 4
# phase 24 compares the card's fusion with the CPU's on its first
# references only (the card fuses all of them): the CPU's votes take
# about 3.6 s a reference at 1920x1056 with 10 sources
TNT_CPU_REFS = 2
# phase 25: scripts/e2e_synthetic_torch.py at its headline configuration
# (the JAX chain's ACCURACY_r05_quirkoff.json) for 2 of its 16 epochs, 128
# steps each; the second epoch's mean loss must fall to this share of the
# first's at most (the JAX chain's record: 0.469 -> 0.076)
CHAIN_ARGV = ["--align_corners", "--d0", "48", "--ndepths", "32,16,8", "--batch_size", "2",
              "--lr", "1e-3", "--conf", "0.1,0.15,0.5", "--epochs", "2"]
CHAIN_LOSS_DROP = 0.3
CONF_ROUNDING = 1e-5  # a confidence may pass 1 by fp32 rounding of its sum
# K1 runs on the scene's FeatureNet maps with the trained weights.
# Tolerance on (kernel - plain) / (1 + |plain|), elementwise. fp32: both
# evaluate the projective geometry in fp32 in another order, a few ulps of
# a pixel coordinate near 1000 (~1e-4 px), amplified by the features'
# gradient (2e-3 holds even for white-noise features). bf16: both sum in
# fp32 and round once; one bf16 step is 2^-7.
K1_TOL = {"fp32": 2e-3, "bf16": 2.0 ** -7 + 2e-3}
# K4 against its plain version (fp32), on (kernel - plain) / (1 + |plain|):
# fp32 is K1's reason; bf16: the plain version samples the same bf16 inputs
# in fp32 and the kernel rounds once (half a bf16 step, 2^-9 relative).
# K4's variance entry is held to the same limits against the plain
# variance cost volume on the same inputs in fp32: the samples carry the
# geometry's rounding into the fp32 sums, and in bf16 the kernel rounds the
# variance once.
K4_TOL = {"fp32": 2e-3, "bf16": 2.0 ** -8 + 2e-3}
# K2, on an fp32 cost and on a bf16 one (read exactly; the plain version
# upcasts it): prob to 1e-6; depth and sigma3 to 1e-4 of sums over up to 64
# hypotheses of depths near 5..10; confidence flips where trunc(sum p*d)
# lands on the other side of an integer.
K2_TOL = {"prob_volume": 1e-6, "depth": 1e-4, "variance": 1e-4}
K2_MAX_FLIP_SHARE = 1e-4
DEPTH_TOL_SHARE = 0.002  # p999 |depth - plain depth| <= 0.2 % of the range
# The bf16 depth's own sensitivity: how far the plain route's bf16 depth
# moves when every camera-matrix entry moves by one fp32 ulp (up or down,
# seeded), a geometry difference of the size the kernels and the plain
# versions have at every stage (they evaluate the projective geometry in
# another order). scripts/bf16_sensitivity_torch.py measured the
# kernels-vs-plain gap at about this floor on the trained model and with a
# seeded FMT pathway, whose floor is above DEPTH_TOL_SHARE's 0.0176: phase
# 14 holds its bf16 gap to the larger of the two limits, the floor taken
# BF16_FLOOR_FACTOR times.
BF16_FLOOR_FACTOR = 1.5
# GEOREG_BF16_FLOOR, phase 16: the seeded GeoRegNet2d's cost is nearly flat
# over the hypotheses (stage 1's to 1e-10), so the probability volumes are
# nearly uniform and each stage's depth and 3-sigma band ride on their
# smallest wiggles. scripts/georeg_bf16_torch.py traced the kernels' bf16
# gap to K1 alone (K2 alone moves the depth by 3e-5), entering with stage
# 2's cost volume; the plain route itself moves as far when its fp32 cost
# volumes move by one ulp, or when the same request lists its source views
# in reverse order. Phase 16 holds the bf16 gap to the larger of
# DEPTH_TOL_SHARE's limit and BF16_FLOOR_FACTOR times that one-ulp volume
# move, measured in every run beside a planted fault that must exceed it.
# The seeded model's depth is nearly constant (its stage-2 depth varies by
# 2.4e-5 over the image in fp32), so faults that leave each stage's band
# where it was (a handed-over volume shifted or unnormalised, a source view
# dropped, the volume rolled by one hypothesis before the regression) move
# the bf16 depth by less than this limit (scripts/georeg_bf16_torch.py
# records them). fp32 (TF32 off) is held at GEOREG_FP32_TOL, the fp32 limit
# of phases 20 and 24: the kernels' fp32 gap is 3e-6, a dropped source
# view moves the depth by 0.0075; the handoff faults move it by under 1e-5
# in fp32 too, and only a trained GeoReg checkpoint can show them.
GEOREG_FP32_TOL = 1e-3
# training shapes (scripts/bench_train.py:48)
TRAIN_H, TRAIN_W, TRAIN_B, TRAIN_STEPS = 512, 640, 4, 3
# K3 against autograd of the plain version, per feature-gradient tensor:
#   relative L2 error ||kernel - plain|| / ||plain|| <= l2, and elementwise
#   |kernel - plain| <= rel * |plain| + share * max|plain|.
# fp32: the two evaluate the projective geometry in another order (a few
# ulps of a pixel coordinate, K1's reason above) and every source-gradient
# tap is weighted by it; the kernel's fp32 atomics add in an order that
# changes from run to run. A first H100 run measured relative L2 errors up
# to 1.3e-3 and a largest elementwise excess of 8.6e-3 of the max (stage 1
# dsrc, at a few pixels); the elementwise bound is loose on purpose, the
# L2 bound is the test. bf16: the plain version runs in fp32 on the same bf16-rounded
# inputs; the kernel computes in fp32 and rounds dref and dsrc once to bf16
# (half a step, 2^-8 relative; ~2^-8/sqrt(3) in L2).
K3_TOL = {"fp32": {"l2": 2e-3, "rel": 0.0, "share": 2e-2},
          "bf16": {"l2": 2.0 ** -8 + 2e-3, "rel": 2.0 ** -8, "share": 2e-2}}
# the weight-net partials are fp32 sums over every voxel and view in both
# dtypes: 1e-3 of the largest
K3_WNET_TOL = 1e-3
# The training step on the kernels against the plain versions (fp32, TF32
# off). The loss: rtol 1e-4. The gradient: its relative L2 error over all
# parameters <= 1e-2. Per tensor the gradient is not held tighter: it is
# piecewise smooth, and where rounding moves a ReLU input across zero many
# tensors' gradients jump by percents (scripts/grad_sensitivity_torch.py
# shows it on the CPU), so the run prints each tensor's max |d| / max |g|
# instead.
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_L2 = 1e-2
# the non-fused steps: timed steps (phase 10 adaptive, phase 11 variance),
# and phase 12's small shape, held to STEP_LOSS_RTOL and STEP_GRAD_L2
NONFUSED_STEPS, VARIANCE_STEPS = 3, 2
# phase 15: timed variant steps; the undetached handoff must move stage 1's
# U-Net gradient by more than this relative L2 against the detached step's
VARIANT_STEPS, UNDETACH_MIN_CHANGE = 2, 1e-3
SMALL_H, SMALL_W, SMALL_NVIEWS, SMALL_D0, SMALL_NDEPTHS = 64, 64, 3, 16, (8, 8, 8)
# phases 17-20: two ranks (processes of this script) on the one card; each
# child's time limit, and gloo's for one collective, in seconds
RANKS, CHILD_TIMEOUT, GLOO_TIMEOUT = 2, 420, 180
# phase 17: the ranks' running statistics against one process, relative to
# each tensor's largest entry (both reduce fp32 sums, in other orders)
DDP_STATS_RTOL = 1e-5
# phase 20: the fp32 depth of the sequence-parallel FMT request against the
# one-process forward, p999 of |difference|. The sound path's gap is the
# order of the sums alone; a planted fault (the attention's all-reduce left
# out) must exceed the limit in every run (PERF.md section 6, PR 9).
FMT_SP_FP32_TOL = 1e-3
# phase 21: the fp32 depth of the slab request against the one-process
# forward, p999 of |difference|: phase 20's limit (the slabs reorder the
# sums; a planted fault, the halos zeroed, must exceed it in every run)
SLAB_FP32_TOL = FMT_SP_FP32_TOL
# phase 18: the training CLI's synthetic samples, 2 global batches
CLI_TRAIN_H, CLI_TRAIN_W, CLI_TRAIN_SAMPLES = 128, 160, 8
# phase 19: the scan-parallel test CLI's scenes (phase 13's, seeds 3 and 4)
SCAN_SCENES = ["scan_a", "scan_b"]
# the step's image summaries, the JAX step's keys
IMAGE_KEYS = ("depth_est", "depth_gt", "ref_img", "mask", "errormap", "photometric_confidence")
# K5, CostRegNet's prob conv (Conv3d(8, 1, 3)), against F.conv3d of the
# rounded weight in fp32: both sum 216 fp32 products in other orders, 1e-5
# of the output's largest entry; bf16 adds one bf16 step of the reference
# (the kernel rounds once; the reordering can cross a rounding boundary)
PROB_CHANNELS, PROB_KERNEL = 8, "prob_conv3d_kernel"
PROB_TOL = 1e-5
# the library convolution with the weight zero-padded to these output
# channels (channels_last_3d, cudnn.benchmark), timed beside K5: alone, and
# with the slice of channel 0 made contiguous, as K2 reads it
PROB_PADDED_COUT = (8, 16)
# name keys of the kernels in profiler traces; the template argument after
# the dtype is C, which names the stage (C = 32 / 16 / 8 at stages 1 / 2 / 3)
K1_KERNEL, K2_KERNEL, K3_KERNEL, K4_KERNEL, K4_VARIANCE_KERNEL = (
    "fused_costvol_kernel", "probstats_kernel", "fused_costvol_bwd_kernel",
    "sweep_sampler_kernel", "sweep_variance_kernel")
STAGE_OF_C = {32: 1, 16: 2, 8: 3}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def cuda_ms(fn, iters, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, key, iters=5):
    """Device time per call of the kernels whose names hold ``key``, under
    torch.profiler: the kernel alone, without the host work of the call
    (which CUDA events see whenever it outlasts the kernel)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace can come back without its device events
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA and key in e.name
                 and not e.name.startswith("Activity Buffer"))
        if us > 0:
            return us / 1e3 / iters
    raise RuntimeError(f"check failed: three traces saw no device kernel named like {key!r}")


def kernel_channels(name):
    """C, the kernel's channel template argument, from a demangled
    (``kernel<__nv_bfloat16, 32>``) or mangled (``...Li32EE``) name."""
    import re
    m = re.search(r"_kernel<[^,<>]+,\s*(\d+)>", name) or re.search(r"_kernelI.*?Li(\d+)E", name)
    check(m is not None, f"no channel count in the kernel name {name!r}")
    return int(m.group(1))


def device_ms_by_stage(prof, key):
    """{stage: device ms} of the kernels whose names hold ``key`` in a
    profile, the stage read from the kernel's channel count."""
    from torch.autograd import DeviceType
    ms = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and key in e.name:
            stage = STAGE_OF_C[kernel_channels(e.name)]
            ms[stage] = ms.get(stage, 0.0) + e.time_range.elapsed_us() / 1e3
    return ms


def p999(x):
    """99.9th percentile of a large tensor (top-k, as quantile() caps its
    input size)."""
    import torch
    flat = x.reshape(-1).float()
    k = max(1, math.ceil(flat.numel() * 0.001))
    return float(torch.topk(flat, k).values.min())


def stage_geometry(sample, stage, dev):
    import torch
    from damvsnet_tpu_torch.model.cascade import fuse_projection_matrices
    proj = torch.as_tensor(sample["proj_matrices"][f"stage{stage}"][None], device=dev)
    fused = fuse_projection_matrices(proj)
    return fused[:, 0], [fused[:, v] for v in range(1, fused.shape[1])]


def stage_features(sample, model, dev, dtype):
    """The FeatureNet's NHWC maps of the scene's N views, per stage: the
    tensors the main path hands K1."""
    import torch
    imgs = torch.as_tensor(sample["imgs"], device=dev)  # [N, H, W, 3]
    feats = model.feature(imgs.permute(0, 3, 1, 2).to(dtype))
    return [feats[f"stage{s}"].permute(0, 2, 3, 1).contiguous()[:, None]
            for s in (1, 2, 3)]  # [N, B=1, h, w, C]


def sweep(sample, stage_idx, dev, gen):
    """Stage 1: the uniform [B, D] sweep; stages 2/3: per-pixel hypotheses
    drawn over the whole sweep range (a wider spread than ADIA's)."""
    import torch
    h, w = HEIGHT >> (2 - stage_idx), WIDTH >> (2 - stage_idx)
    d = NDEPTHS[stage_idx]
    lo, hi = float(sample["depth_values"][0]), float(sample["depth_values"][-1])
    if stage_idx == 0:
        return torch.linspace(lo, hi, d, device=dev)[None]
    dv = lo + (hi - lo) * torch.rand(1, d, h, w, generator=gen, device=dev)
    return dv.sort(dim=1).values


def k1_bound_ms(b, d, h, w, c, v, elem, per_pixel):
    bytes_ = ((v + 1) * b * h * w * c * elem + b * d * (h * w if per_pixel else 1) * 4
              + b * d * h * w * c * elem)
    # per voxel and view: geometry ~30, 4 taps x C fma, d2 and the weight
    # dot 4C, weight net ~8, accumulate 2C; then the 1/(N-1) scale
    ops = b * d * h * w * (v * (14 * c + 60) + c)
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def k2_bound_ms(b, d, h, w, per_pixel, cost_elem):
    """The cost read once in its dtype, the depths, prob and the three maps
    written once in fp32."""
    n = b * h * w
    bytes_ = n * d * (cost_elem + 4) + (n * d if per_pixel else b * d) * 4 + 3 * n * 4
    ops = n * d * 17 + n * 4  # 4 passes over d, the 4-tap window
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_k1(sample, model, dev):
    import torch
    from damvsnet_tpu_torch.ops.kernels import fused_costvol as K
    from damvsnet_tpu_torch.nn.aggweight import fold_aggweight
    gen = torch.Generator(device=dev).manual_seed(0)
    feats = {tag: stage_features(sample, model, dev, dtype)
             for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16))}
    rows = []
    for stage_idx in range(3):
        ref_p, src_p = stage_geometry(sample, stage_idx + 1, dev)
        dv = sweep(sample, stage_idx, dev, gen)
        wts = fold_aggweight(model.DepthNet.weight_net[stage_idx])
        # the serving convention timed; align_corners=True (the accuracy
        # chain's) held against the plain version on the same inputs
        for tag, ac in (("fp32", False), ("bf16", False), ("fp32", True), ("bf16", True)):
            feas = feats[tag][stage_idx]
            args = (feas[0], list(feas[1:]), ref_p, src_p, dv, *wts, ac)
            got = K.fused_adaptive_cost_volume(*args)
            torch.cuda.synchronize()
            want = K.fused_adaptive_cost_volume_plain(*args)
            diff = (got.float() - want.float()).abs()
            rel = float((diff / (1 + want.float().abs())).max())
            row = {"stage": stage_idx + 1, "dtype": tag, "align_corners": ac,
                   "shape": list(got.shape), "max_abs": float(diff.max()),
                   "p999_abs": p999(diff), "max_rel": rel, "tol_rel": K1_TOL[tag]}
            if not ac:
                row.update({
                    "ms": cuda_ms(lambda: K.fused_adaptive_cost_volume(*args), 20),
                    "plain_ms": cuda_ms(lambda: K.fused_adaptive_cost_volume_plain(*args), 3, 1),
                    "kernel_ms": device_ms(lambda: K.fused_adaptive_cost_volume(*args),
                                           K1_KERNEL)})
                b, d, h, w, c = got.shape
                row["bound_ms"], row["bound_by"] = k1_bound_ms(
                    b, d, h, w, c, NVIEWS - 1, got.element_size(), dv.dim() == 4)
            print("K1", json.dumps(row), flush=True)
            check(rel <= K1_TOL[tag], f"K1 stage {stage_idx + 1} {tag} align_corners={ac}: "
                  f"max rel {rel} > {K1_TOL[tag]}")
            rows.append(row)
            del got, want, diff
    torch.cuda.empty_cache()
    return rows


def phase_k2(sample, dev):
    import torch
    from damvsnet_tpu_torch.ops.kernels.probstats import prob_volume_stats_fused
    from damvsnet_tpu_torch.ops.regression import prob_volume_stats
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for stage_idx in range(3):
        h, w = HEIGHT >> (2 - stage_idx), WIDTH >> (2 - stage_idx)
        d = NDEPTHS[stage_idx]
        cost32 = 3 * torch.randn(1, d, h, w, generator=gen, device=dev)
        dv = sweep(sample, stage_idx, dev, gen)
        # the stats are fp32 in both modes; "bf16" feeds the bf16 cost the
        # bf16 cascade hands the kernel (the plain version upcasts it)
        for tag, cost in (("fp32", cost32), ("bf16", cost32.bfloat16())):
            got = prob_volume_stats_fused(cost, dv)
            torch.cuda.synchronize()
            want = prob_volume_stats(cost, dv)
            row = {"stage": stage_idx + 1, "dtype": tag, "shape": [1, d, h, w]}
            for key, tol in K2_TOL.items():
                err = float((got[key] - want[key]).abs().max())
                row[f"max_abs_{key}"] = err
                check(err <= tol, f"K2 stage {stage_idx + 1} {tag} {key}: {err} > {tol}")
            flips = int(((got["photometric_confidence"]
                          - want["photometric_confidence"]).abs() > 1e-5).sum())
            row["conf_flips"] = flips
            row["max_abs"] = max(row[f"max_abs_{k}"] for k in K2_TOL)
            row["ms"] = cuda_ms(lambda: prob_volume_stats_fused(cost, dv), 50)
            row["plain_ms"] = cuda_ms(lambda: prob_volume_stats(cost, dv), 10, 1)
            row["kernel_ms"] = device_ms(lambda: prob_volume_stats_fused(cost, dv), K2_KERNEL)
            row["bound_ms"], row["bound_by"] = k2_bound_ms(1, d, h, w, dv.dim() == 4,
                                                           cost.element_size())
            print("K2", json.dumps(row), flush=True)
            check(flips <= max(2, K2_MAX_FLIP_SHARE * h * w),
                  f"K2 stage {stage_idx + 1} {tag}: {flips} confidence flips")
            rows.append(row)
    return rows


def prob_conv_bound_ms(b, d, h, w, elem):
    """K5: the 8-channel volume read once and the output written once in
    the compute dtype; 216 fp32 FMAs (432 operations) an output voxel."""
    n = b * d * h * w
    bytes_ = n * (PROB_CHANNELS + 1) * elem + PROB_CHANNELS * 27 * elem
    ops = n * PROB_CHANNELS * 27 * 2
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_prob_conv(model, dev):
    """K5, CostRegNet's Cout=1 prob conv, at each serving stage's shape
    with that stage's trained weight, on a channels_last_3d volume (the
    U-Net's layout), fp32 (TF32 off) and bf16, against F.conv3d of the
    weight rounded to the dtype, in fp32, at PROB_TOL; in bf16 timed beside
    the plain version (conv(), cuDNN as the port ran it), cuDNN with
    ``cudnn.benchmark`` (its timed choice of algorithm), and cuDNN on the
    weight zero-padded to PROB_PADDED_COUT output channels."""
    import torch
    import torch.nn.functional as F
    from damvsnet_tpu_torch.nn.blocks import conv
    from damvsnet_tpu_torch.ops.kernels.prob_conv import prob_conv3d
    gen = torch.Generator(device=dev).manual_seed(7)
    rows = []
    for stage_idx in range(3):
        h, w = HEIGHT >> (2 - stage_idx), WIDTH >> (2 - stage_idx)
        d = NDEPTHS[stage_idx]
        m = model.cost_regularization[stage_idx].prob
        x32 = torch.randn(1, d, h, w, PROB_CHANNELS, generator=gen,
                          device=dev).permute(0, 4, 1, 2, 3)
        for tag, x in (("fp32", x32), ("bf16", x32.bfloat16())):
            got = prob_conv3d(x, m.weight)
            torch.cuda.synchronize()
            want = F.conv3d(x.float(), m.weight.to(x.dtype).float(), padding=1)
            err = (got.float() - want).abs()
            tol = PROB_TOL * want.abs().max()
            if tag == "bf16":  # one bf16 step at |want|
                tol = tol + torch.ldexp(torch.ones_like(want), torch.frexp(want).exponent - 8)
            row = {"stage": stage_idx + 1, "dtype": tag, "shape": list(x.shape),
                   "channels_last_3d": x.is_contiguous(memory_format=torch.channels_last_3d),
                   "max_abs": float(err.max()), "max_rel_to_max": float(err.max() /
                                                                         want.abs().max())}
            check(bool((err <= tol).all()), f"K5 stage {stage_idx + 1} {tag}: "
                  f"max |err| {row['max_abs']} past its limit")
            if tag == "bf16":  # the serving dtype: the kernel table's times
                row["ms"] = cuda_ms(lambda: prob_conv3d(x, m.weight), 50)
                row["kernel_ms"] = device_ms(lambda: prob_conv3d(x, m.weight), PROB_KERNEL)
                row["plain_ms"] = cuda_ms(lambda: conv(x, m), 20)
                torch.backends.cudnn.benchmark = True
                try:
                    row["library_ms"] = cuda_ms(lambda: conv(x, m), 20, warmup=3)
                    for cout in PROB_PADDED_COUT:  # the one-route alternative
                        wp = torch.zeros((cout, *m.weight.shape[1:]), dtype=x.dtype, device=dev)
                        wp[:1] = m.weight.to(x.dtype)
                        wp = wp.contiguous(memory_format=torch.channels_last_3d)
                        row[f"pad{cout}_ms"] = cuda_ms(
                            lambda: F.conv3d(x, wp, padding=1), 20, warmup=3)
                        row[f"pad{cout}_route_ms"] = cuda_ms(
                            lambda: F.conv3d(x, wp, padding=1)[:, 0].contiguous(), 20, warmup=3)
                finally:
                    torch.backends.cudnn.benchmark = False
                row["bound_ms"], row["bound_by"] = prob_conv_bound_ms(1, d, h, w, 2)
            print("K5", json.dumps(row), flush=True)
            rows.append(row)
    return rows


def many_view_features(model, dev):
    """A synthetic scene of MANY_VIEWS + 1 views at MANY_H x MANY_W: per
    stage the fused projections (reference, sources), a uniform sweep of
    the stage's depth count and the FeatureNet's NHWC maps [N, 1, h, w, C]
    in fp32 and bf16."""
    import torch
    from damvsnet_tpu_torch.data.synthetic import make_synthetic_sample
    sample = make_synthetic_sample(height=MANY_H, width=MANY_W, nviews=MANY_VIEWS + 1,
                                   ndepths=D0, seed=SEED, with_gt=False)
    lo, hi = float(sample["depth_values"][0]), float(sample["depth_values"][-1])
    with torch.no_grad():
        feats = {tag: stage_features(sample, model, dev, dtype)
                 for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16))}
    return [(*stage_geometry(sample, s + 1, dev),
             torch.linspace(lo, hi, NDEPTHS[s], device=dev)[None],
             {tag: f[s] for tag, f in feats.items()}) for s in range(3)]


def rel_l2(got, want):
    import torch
    return float(torch.linalg.vector_norm(got.float() - want) /
                 max(float(torch.linalg.vector_norm(want)), 1e-30))


def phase_k1_many_views(model, dev):
    """K1 with MANY_VIEWS source views (one launch takes 16): the wrapper
    splits them into two launches and sums; forward against the plain
    version at K1_TOL, and the features' gradients through autograd (K3
    per launch) against autograd of the plain version in fp32 at K3_TOL's
    relative L2."""
    import torch
    from damvsnet_tpu_torch.nn.aggweight import fold_aggweight
    from damvsnet_tpu_torch.ops.kernels import fused_costvol as K
    gen = torch.Generator(device=dev).manual_seed(6)
    for stage_idx, (ref_p, src_p, dv, feats) in enumerate(many_view_features(model, dev)):
        with torch.no_grad():
            wts = fold_aggweight(model.DepthNet.weight_net[stage_idx])
        for tag in ("fp32", "bf16"):
            feas = [f for f in feats[tag]]  # [1, h, w, C] each
            leaves = [f.clone().requires_grad_() for f in feas]
            n0 = (K.fused_adaptive_cost_volume.launches,
                  K.fused_adaptive_cost_volume_backward.launches)
            got = K.fused_adaptive_cost_volume(leaves[0], leaves[1:], ref_p, src_p, dv, *wts)
            cot = torch.randn(got.shape, generator=gen, device=dev)
            (got.float() * cot).sum().backward()
            launched = (K.fused_adaptive_cost_volume.launches - n0[0],
                        K.fused_adaptive_cost_volume_backward.launches - n0[1])
            ref = [f.float().clone().requires_grad_() for f in feas]
            want = K.fused_adaptive_cost_volume_plain(ref[0], ref[1:], ref_p, src_p, dv, *wts)
            (want * cot).sum().backward()
            diff = (got.detach().float() - want.detach()).abs()
            rel = float((diff / (1 + want.detach().abs())).max())
            l2 = max(rel_l2(a.grad, r.grad) for a, r in zip(leaves, ref))
            row = {"stage": stage_idx + 1, "dtype": tag, "views": MANY_VIEWS,
                   "shape": list(got.shape), "launches": list(launched),
                   "max_abs": float(diff.max()), "max_rel": rel, "tol_rel": K1_TOL[tag],
                   "grad_rel_l2": l2, "tol_grad_rel_l2": K3_TOL[tag]["l2"]}
            print("K1 past 16 views", json.dumps(row), flush=True)
            check(launched == (2, 2), f"K1 with {MANY_VIEWS} views: launches {launched}")
            check(rel <= K1_TOL[tag], f"K1 {MANY_VIEWS} views stage {stage_idx + 1} {tag}: "
                  f"max rel {rel} > {K1_TOL[tag]}")
            check(l2 <= K3_TOL[tag]["l2"], f"K1/K3 {MANY_VIEWS} views stage {stage_idx + 1} "
                  f"{tag}: gradient relative L2 {l2} > {K3_TOL[tag]['l2']}")


def serving_batch(sample):
    return {"imgs": sample["imgs"][None],
            "proj_matrices": {k: v[None] for k, v in sample["proj_matrices"].items()},
            "depth_values": sample["depth_values"][None]}


def depth_parity(runner, model, batch, rng, bf16_depth):
    """p999 and max |depth - plain-path depth| in bf16 (``bf16_depth``, a
    request on the kernels, against one plain request) and in fp32 with
    TF32 off, each beside its limit, DEPTH_TOL_SHARE of the depth range.
    Leaves the model on the kernels in bf16, and TF32 off."""
    import numpy as np
    import torch
    results = {"bf16": bf16_depth}
    model.plain = True
    plain = {"bf16": runner(batch)["depth"]}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model.compute_dtype = torch.float32
    model.plain = False
    results["fp32"] = runner(batch)["depth"]
    model.plain = True
    plain["fp32"] = runner(batch)["depth"]
    model.plain, model.compute_dtype = False, torch.bfloat16
    parity = {}
    for tag in ("bf16", "fp32"):
        diff = np.abs(results[tag] - plain[tag])
        parity[tag] = {"p999_abs": float(np.quantile(diff, 0.999)),
                       "max_abs": float(diff.max()),
                       "tol": DEPTH_TOL_SHARE * rng}
    return parity


def bf16_floor(runner, model, batch):
    """p999 |d depth| of the plain route in bf16 between the batch and the
    batch with every camera-matrix entry moved by one fp32 ulp, up or down
    (seeded). Leaves the model on the kernels."""
    import numpy as np
    model.plain = True
    base = runner(batch)["depth"]
    rs = np.random.default_rng(0)
    moved = dict(batch, proj_matrices={
        k: (v * (1.0 + 2.0 ** -23 * rs.choice([-1.0, 1.0], v.shape[1:]))).astype(np.float32)
        for k, v in batch["proj_matrices"].items()})
    diff = np.abs(runner(moved)["depth"] - base)
    model.plain = False
    return float(np.quantile(diff, 0.999))


def reset_counters():
    """Every kernel wrapper's launch counter (``ops.kernels.COUNTED``) to 0:
    each path sets them all just before it runs and reads them all just
    after."""
    from damvsnet_tpu_torch.ops.kernels import COUNTED
    for fn in COUNTED:
        fn.launches = 0


def read_counters():
    from damvsnet_tpu_torch.ops.kernels import COUNTED
    return {fn.__name__: fn.launches for fn in COUNTED}


def check_launches(path, launches, per_unit, units):
    """Every kernel's launches on a path against ``per_unit`` (request or
    step) times ``units``; a kernel missing from ``per_unit`` must not
    launch."""
    for name, n in launches.items():
        want = per_unit.get(name, 0) * units
        check(n == want, f"{path}: {name} launched {n} times in {units} "
              f"runs, expected {want}")


def timed_requests(runner, batch):
    """One warm-up request (cuDNN's first-call setup), then REQUESTS timed
    requests with every launch counter set to 0 just before and read just
    after. Returns (warm-up ms, [request ms], the last output, {counter:
    launches}, peak GiB)."""
    import torch
    t0 = time.perf_counter()
    runner(batch)
    warm_ms = (time.perf_counter() - t0) * 1e3
    reset_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, out = [], None
    for _ in range(REQUESTS):
        t0 = time.perf_counter()
        out = runner(batch)
        times.append((time.perf_counter() - t0) * 1e3)
    launches = read_counters()
    return warm_ms, times, out, launches, torch.cuda.max_memory_allocated() / 2 ** 30


def phase_cascade(sample, model, dev):
    import numpy as np
    import torch
    from damvsnet_tpu_torch.infer import DepthRunner
    batch = serving_batch(sample)
    rng = float(sample["depth_values"][-1] - sample["depth_values"][0])
    runner = DepthRunner(model, device=dev)
    model.compute_dtype, model.plain = torch.bfloat16, False
    warm_ms, times, out, launches, peak_gib = timed_requests(runner, batch)
    print("cascade", json.dumps({"warmup_ms": warm_ms, "request_ms": times,
                                 "peak_mem_gib": peak_gib, "launches": launches}),
          flush=True)
    check_launches("cascade", launches, {"fused_adaptive_cost_volume": 3,
                                         "prob_volume_stats_fused": 3, "prob_conv3d": 3},
                   REQUESTS)
    depth = out["depth"]
    check(depth.shape == (1, HEIGHT, WIDTH), f"depth shape {depth.shape}")
    check(bool(np.isfinite(depth).all()), "non-finite depth")
    gt = sample["depth"]["stage3"][None]
    print("cascade vs scene depth", json.dumps({
        "median_abs_err": float(np.median(np.abs(depth - gt))),
        "depth_range": rng}), flush=True)

    parity = depth_parity(runner, model, batch, rng, depth)
    print("cascade vs plain", json.dumps(parity), flush=True)
    for tag, p in parity.items():
        check(p["p999_abs"] <= p["tol"], f"cascade {tag}: depth p999 "
              f"{p['p999_abs']} > {p['tol']}")
    return launches, float(np.mean(times))


def k3_bound_ms(b, d, h, w, c, v, elem, per_pixel):
    """The features and the cotangent read once, dref and dsrc written once
    in the feature dtype; per voxel and view the forward's ~(14C + 60)
    operations recomputed plus ~(14C + 10) for the backward (dL/dd2, dref,
    dw1 and the four taps' scatter)."""
    bytes_ = ((v + 1) * b * h * w * c * elem * 2 + b * d * (h * w if per_pixel else 1) * 4
              + b * d * h * w * c * elem)
    ops = b * d * h * w * v * (28 * c + 70)
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def train_batch(seeds):
    """A collated batch of synthetic scenes at the training width."""
    from damvsnet_tpu_torch.data.common import collate
    from damvsnet_tpu_torch.data.synthetic import make_synthetic_sample
    return collate([make_synthetic_sample(height=TRAIN_H, width=TRAIN_W, nviews=NVIEWS,
                                          ndepths=D0, seed=k) for k in seeds])


def phase_k3(model, dev):
    import torch
    from damvsnet_tpu_torch.model.cascade import fuse_projection_matrices
    from damvsnet_tpu_torch.nn.aggweight import fold_aggweight
    from damvsnet_tpu_torch.ops.kernels import fused_costvol as K
    batch = train_batch(range(TRAIN_B))
    imgs = torch.as_tensor(batch["imgs"], device=dev)  # [B, N, H, W, 3]
    b, n = imgs.shape[:2]
    lo = torch.as_tensor(batch["depth_values"][:, 0], device=dev)
    hi = torch.as_tensor(batch["depth_values"][:, -1], device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    feats = {}
    for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        x = imgs.reshape(b * n, TRAIN_H, TRAIN_W, 3).permute(0, 3, 1, 2).to(dtype)
        nhwc = [m.permute(0, 2, 3, 1).contiguous() for m in model.feature(x).values()]
        feats[tag] = [m.view(b, n, *m.shape[1:]) for m in nhwc]  # stages 1..3
    rows = []
    for stage_idx in range(3):
        h, w = TRAIN_H >> (2 - stage_idx), TRAIN_W >> (2 - stage_idx)
        d = NDEPTHS[stage_idx]
        proj = torch.as_tensor(batch["proj_matrices"][f"stage{stage_idx + 1}"], device=dev)
        fused = fuse_projection_matrices(proj)
        ref_p, src_p = fused[:, 0], [fused[:, v] for v in range(1, n)]
        if stage_idx == 0:
            t = torch.linspace(0, 1, d, device=dev)[None]
            dv = lo[:, None] + (hi - lo)[:, None] * t
        else:
            u = torch.rand(b, d, h, w, generator=gen, device=dev).sort(dim=1).values
            dv = lo[:, None, None, None] + (hi - lo)[:, None, None, None] * u
        wts = fold_aggweight(model.DepthNet.weight_net[stage_idx])
        cot32 = torch.randn(b, d, h, w, STAGE_C[stage_idx], generator=gen, device=dev)
        # the serving convention timed; align_corners=True held alone
        for tag, ac in (("fp32", False), ("bf16", False), ("fp32", True), ("bf16", True)):
            feas = feats[tag][stage_idx]
            ref, srcs = feas[:, 0].contiguous(), [feas[:, v].contiguous() for v in range(1, n)]
            cot = cot32.to(ref.dtype)
            args = (ref, srcs, ref_p, src_p, dv, *wts, ac)
            got = K.fused_adaptive_cost_volume_backward(cot, *args)
            torch.cuda.synchronize()
            plain_args = (ref.float(), [s.float() for s in srcs], ref_p, src_p, dv, *wts, ac)
            want = K.fused_adaptive_cost_volume_backward_plain(cot.float(), *plain_args)
            tol = K3_TOL[tag]
            row = {"stage": stage_idx + 1, "dtype": tag, "align_corners": ac,
                   "shape": [b, d, h, w, ref.shape[-1]]}
            failures = []
            for name, g, wnt in [("dref", got[0], want[0])] + [
                    (f"dsrc{v}", gs, ws) for v, (gs, ws) in enumerate(zip(got[1], want[1]))]:
                g, wnt = g.float(), wnt.float()
                err = (g - wnt).abs()
                scale = max(float(wnt.abs().max()), 1e-30)
                excess = float((err - tol["rel"] * wnt.abs()).max()) / scale
                l2 = float(torch.linalg.vector_norm(g - wnt) / torch.linalg.vector_norm(wnt))
                row[f"max_abs_{name}"] = float(err.max())
                row[f"excess_{name}"] = excess
                row[f"rel_l2_{name}"] = l2
                if excess > tol["share"] or l2 > tol["l2"]:
                    failures.append(f"{name}: excess {excess} (limit {tol['share']}), "
                                    f"relative L2 {l2} (limit {tol['l2']})")
            gw = torch.cat([got[2].reshape(-1), *(x.reshape(1) for x in got[3:])])
            ww = torch.cat([want[2].reshape(-1), *(x.reshape(1) for x in want[3:])])
            row["wnet_rel_err"] = float((gw - ww).abs().max()) / max(float(ww.abs().max()), 1e-30)
            if row["wnet_rel_err"] > K3_WNET_TOL:
                failures.append(f"weight net: {row['wnet_rel_err']} > {K3_WNET_TOL}")
            row["max_abs"] = max(v for k, v in row.items() if k.startswith("max_abs_"))
            if not ac:
                row["ms"] = cuda_ms(lambda: K.fused_adaptive_cost_volume_backward(cot, *args), 5)
                row["k1_ms"] = cuda_ms(lambda: K.fused_adaptive_cost_volume(*args), 5)
                row["kernel_ms"] = device_ms(
                    lambda: K.fused_adaptive_cost_volume_backward(cot, *args), K3_KERNEL, 3)
                row["k1_kernel_ms"] = device_ms(lambda: K.fused_adaptive_cost_volume(*args),
                                                K1_KERNEL, 3)
                row["plain_ms"] = cuda_ms(
                    lambda: K.fused_adaptive_cost_volume_backward_plain(cot, *args), 1, 1)
                row["bound_ms"], row["bound_by"] = k3_bound_ms(
                    b, d, h, w, ref.shape[-1], n - 1, ref.element_size(), dv.dim() == 4)
            print("K3", json.dumps(row), flush=True)
            check(not failures, f"K3 stage {stage_idx + 1} {tag} align_corners={ac}: {failures}")
            rows.append(row)
            del got, want
        torch.cuda.empty_cache()
    return rows


def grads_of_one_step(model, batch, plain):
    """Loss and gradients of one training forward + backward on ``batch``
    (a device batch), from the weights and statistics the model holds."""
    import torch
    from damvsnet_tpu_torch.losses import cas_mvsnet_loss
    model.plain = plain
    model.zero_grad(set_to_none=True)
    out = model(batch["imgs"], batch["proj_matrices"], batch["depth_values"])
    total, _, _ = cas_mvsnet_loss(out, batch["imgs"], batch["proj_matrices"],
                                  batch["depth"], batch["mask"], use_cpc=True)
    total.backward()
    model.plain = False
    grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
    del out
    torch.cuda.synchronize()
    return float(total.detach()), grads


def timed_training(dev, path, steps, seeded=(), **config):
    """A bf16 model of ``config`` on the trained weights (the modules named
    in ``seeded`` from a seeded init, ``load_bench_weights``), Adam under the
    warmup schedule, make_train_step at phase 7's full width: 1 warm step,
    then ``steps`` timed ones on their own batches with every launch
    counter set to 0 just before and read just after. Prints the path's
    line, checks the metrics are finite and the parameters moved. Returns
    (model, state, step, batches, the state_dict before training,
    {counter: launches}, mean step ms, peak GiB)."""
    import torch
    from damvsnet_tpu_torch.model import CascadeMVSNet
    from damvsnet_tpu_torch.train.loop import make_train_step
    from damvsnet_tpu_torch.train.schedule import make_optimizer
    from damvsnet_tpu_torch.train.state import TrainState
    from damvsnet_tpu_torch.utils.weights import load_bench_weights

    torch.manual_seed(SEED)
    model = CascadeMVSNet(ndepths=NDEPTHS, compute_dtype=torch.bfloat16, device=dev,
                          **config)
    load_bench_weights(model, SERVING_WEIGHTS, seeded)  # variance: warns, the weight nets go
    start = {k: v.clone() for k, v in model.state_dict().items()}
    optimizer, scheduler = make_optimizer(model.parameters(), 1e-3, "10,12,14:2",
                                          iters_per_epoch=1000)
    state = TrainState(model, optimizer, scheduler)
    step = make_train_step(device=dev)
    batches = [train_batch(range(TRAIN_B * i, TRAIN_B * (i + 1))) for i in range(steps + 1)]

    t0 = time.perf_counter()
    warm = step(state, batches[0])
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    check(math.isfinite(float(warm["loss"])), f"{path}: warm-up step loss {float(warm['loss'])}")
    before = {k: p.detach().clone() for k, p in model.named_parameters()}

    reset_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    for batch in batches[1:]:
        t0 = time.perf_counter()
        metrics = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        metrics.pop("_images")
        losses.append({k: float(v) for k, v in metrics.items()})
    launches = read_counters()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    moved = sum(int(not torch.equal(p.detach(), before[k]))
                for k, p in model.named_parameters())
    stats_moved = (len(weight_net_stats_moved(model, start))
                   if model.agg_mode == "adaptive" else 0)
    print(path, json.dumps({"warmup_ms": warm_ms, "step_ms": step_ms, "peak_mem_gib": peak_gib,
                            "launches": launches, "params_moved": moved,
                            "params": len(before), "weight_net_stats_moved": stats_moved,
                            "metrics": losses}), flush=True)
    for m in losses:
        check(all(math.isfinite(v) for v in m.values()), f"{path}: non-finite step metrics {m}")
    check(moved > 0, f"{path}: no parameter moved in the timed steps")
    return (model, state, step, batches, start, launches,
            float(sum(step_ms) / len(step_ms)), peak_gib)


def weight_net_stats_moved(model, start):
    """The names of the weight nets' 12 running-statistics tensors that
    differ from ``start``'s."""
    import torch
    names = [k for k in start if k.startswith("DepthNet.weight_net")
             and k.endswith(("running_mean", "running_var"))]
    check(len(names) == 12, f"{len(names)} weight-net running-statistics tensors")
    sd = model.state_dict()
    return [k for k in names if not torch.equal(sd[k], start[k])]


def phase_train(dev):
    import torch
    from damvsnet_tpu_torch.train.loop import batch_to_device

    model, state, step, batches, start, launches, mean_ms, peak_gib = timed_training(
        dev, "train", TRAIN_STEPS, fused_train=True)
    check_launches("training", launches, {"fused_adaptive_cost_volume": 3,
                                          "fused_adaptive_cost_volume_backward": 3},
                   TRAIN_STEPS)
    check(not weight_net_stats_moved(model, start),
          "fused training moved the weight nets' running statistics")

    # one more step, profiled: K1's and K3's device time per stage on the
    # hypotheses the step makes (stage 1 the uniform sweep, then ADIA's)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, batches[1])
        torch.cuda.synchronize()
    step_kernels = {"k1_kernel_ms": device_ms_by_stage(prof, K1_KERNEL),
                    "k3_kernel_ms": device_ms_by_stage(prof, K3_KERNEL)}
    print("train step kernels", json.dumps(step_kernels), flush=True)
    for key, by_stage in step_kernels.items():
        check(sorted(by_stage) == [1, 2, 3], f"profiled step: {key} saw stages {sorted(by_stage)}")

    # one batch, the same weights: kernels against plain versions, fp32
    del state, step
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model.compute_dtype = torch.float32
    batch = batch_to_device(batches[1], dev)
    results = {}
    for plain in (False, True):
        model.load_state_dict(start)
        model.train()
        results[plain] = grads_of_one_step(model, batch, plain)
        torch.cuda.empty_cache()
    check_step_parity("train vs plain (fp32)", results[False], results[True])
    return launches, mean_ms, peak_gib


def check_step_parity(path, kernels, plain):
    """One step's (loss, gradients) on the kernels against the plain
    versions: printed, and held to STEP_LOSS_RTOL and STEP_GRAD_L2."""
    import torch
    (lk, gk), (lp, gp) = kernels, plain
    num = sum(float(((gk[k] - gp[k]) ** 2).sum()) for k in gk)
    den = sum(float((gp[k] ** 2).sum()) for k in gp)
    l2 = math.sqrt(num / max(den, 1e-30))
    per_tensor = sorted(float((gk[k] - gp[k]).abs().max()) / max(float(gp[k].abs().max()), 1e-30)
                        for k in gk)
    finite = all(bool(torch.isfinite(g).all()) for g in list(gk.values()) + list(gp.values()))
    parity = {"loss_kernels": lk, "loss_plain": lp, "grad_rel_l2": l2,
              "per_tensor_rel_max": {"median": per_tensor[len(per_tensor) // 2],
                                     "p90": per_tensor[int(0.9 * len(per_tensor))],
                                     "max": per_tensor[-1]},
              "tol": {"loss_rtol": STEP_LOSS_RTOL, "grad_rel_l2": STEP_GRAD_L2}}
    print(path, json.dumps(parity), flush=True)
    check(finite, f"{path}: non-finite gradient in the fp32 step")
    check(abs(lk - lp) <= STEP_LOSS_RTOL * abs(lp), f"{path}: fp32 step loss {lk} vs plain {lp}")
    check(l2 <= STEP_GRAD_L2, f"{path}: fp32 step gradient relative L2 error {l2} > "
          f"{STEP_GRAD_L2}")


def phase_train_nonfused(dev, path, agg_mode, steps):
    """Phase 10 (adaptive) or 11 (variance): the non-fused training step at
    phase 7's full width, as the JAX CLI builds it without --fused_train;
    every kernel counter 0 in the timed steps, and (adaptive) the weight
    nets' 12 running-statistics tensors moved. Returns ({counter:
    launches}, mean step ms, peak GiB)."""
    import torch
    model, state, step, _, start, launches, mean_ms, peak_gib = timed_training(
        dev, path, steps, agg_mode=agg_mode, fused_train=False, clamp_samples=False)
    check_launches(path, launches, {}, steps)
    if agg_mode == "adaptive":
        moved = weight_net_stats_moved(model, start)
        check(len(moved) == 12, f"{path}: {len(moved)} of the weight nets' 12 "
              "running-statistics tensors moved")
    del model, state, step
    torch.cuda.empty_cache()
    return launches, mean_ms, peak_gib


def phase_nonfused_vs_cpu():
    """Phase 12: one non-fused step's loss and gradients, adaptive and
    variance, on the card and on the CPU in fp32 (TF32 off on the card,
    oneDNN off on the CPU), on the same weights and the same small batch."""
    import torch
    from damvsnet_tpu_torch.data.common import collate
    from damvsnet_tpu_torch.data.synthetic import make_synthetic_sample
    from damvsnet_tpu_torch.model import CascadeMVSNet
    from damvsnet_tpu_torch.train.loop import batch_to_device
    from damvsnet_tpu_torch.utils.weights import load_bench_weights

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batch = collate([make_synthetic_sample(height=SMALL_H, width=SMALL_W, nviews=SMALL_NVIEWS,
                                           ndepths=SMALL_D0, seed=2)])
    report = {}
    for agg_mode in ("adaptive", "variance"):
        results = {}
        for name in ("cuda", "cpu"):
            model = CascadeMVSNet(ndepths=SMALL_NDEPTHS, device=name, agg_mode=agg_mode,
                                  fused_train=False, clamp_samples=False)
            load_bench_weights(model, SERVING_WEIGHTS)
            model.train()
            with torch.backends.mkldnn.flags(enabled=False):
                results[name] = grads_of_one_step(model, batch_to_device(batch, name),
                                                  plain=False)
        (lc, gc), (lp, gp) = results["cuda"], results["cpu"]
        gc = {k: v.cpu() for k, v in gc.items()}
        num = sum(float(((gc[k] - gp[k]) ** 2).sum()) for k in gc)
        den = sum(float((gp[k] ** 2).sum()) for k in gp)
        l2 = math.sqrt(num / max(den, 1e-30))
        finite = all(bool(torch.isfinite(g).all()) for g in list(gc.values()) + list(gp.values()))
        report[agg_mode] = {"loss_cuda": lc, "loss_cpu": lp, "grad_rel_l2": l2}
        check(finite, f"{agg_mode}: non-finite gradient in the small fp32 step")
        check(abs(lc - lp) <= STEP_LOSS_RTOL * abs(lp),
              f"{agg_mode}: small step loss on the card {lc} vs the CPU {lp}")
        check(l2 <= STEP_GRAD_L2, f"{agg_mode}: small step gradient relative L2 error "
              f"{l2} > {STEP_GRAD_L2}")
    report["tol"] = {"loss_rtol": STEP_LOSS_RTOL, "grad_rel_l2": STEP_GRAD_L2}
    print("non-fused train, card vs CPU (fp32)", json.dumps(report), flush=True)


def k4_bound_ms(b, d, h, w, c, elem, per_pixel):
    """The source read once, the depths, the output written once; per voxel
    the projection and tap weights ~30 operations and 4 taps x C fma."""
    bytes_ = b * h * w * c * elem + b * d * (h * w if per_pixel else 1) * 4 + b * d * h * w * c * elem
    ops = b * d * h * w * (8 * c + 30)
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_k4(sample, model, dev):
    """K4 per stage and dtype on the scene's N-1 source views; ms, plain_ms,
    library_ms and bound_ms are for the stage's N-1 launches (one request's
    worth), ms_per_launch one launch; kernel_ms and library_kernel_ms are
    the device time alone of K4's and grid_sample's kernels."""
    import torch
    import torch.nn.functional as F
    from damvsnet_tpu_torch.ops.kernels.sweep_sampler import plane_sweep_sample
    from damvsnet_tpu_torch.ops.warp import plane_sweep_grid, plane_sweep_warp
    gen = torch.Generator(device=dev).manual_seed(4)
    feats = {tag: stage_features(sample, model, dev, dtype)
             for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16))}
    rows = []
    for stage_idx in range(3):
        ref_p, src_p = stage_geometry(sample, stage_idx + 1, dev)
        dv = sweep(sample, stage_idx, dev, gen)
        views = len(src_p)
        for tag in ("fp32", "bf16"):
            srcs = [f for f in feats[tag][stage_idx][1:]]  # [1, h, w, C] each
            b, h, w, c = srcs[0].shape
            rel = max_abs = 0.0
            for src, p in zip(srcs, src_p):
                got = plane_sweep_sample(src, p, ref_p, dv)
                torch.cuda.synchronize()
                want = plane_sweep_warp(src, p, ref_p, dv)
                diff = (got.float() - want).abs()
                rel = max(rel, float((diff / (1 + want.abs())).max()))
                max_abs = max(max_abs, float(diff.max()))
                del want, diff
            # the reference's call: grid_sample on the [B, D*h, w, 2]
            # normalized grid of the same hypotheses, built here, untimed
            grids, nchw = [], [src.permute(0, 3, 1, 2) for src in srcs]
            for p in src_p:
                px, py = plane_sweep_grid(p, ref_p, dv, h, w)
                g = torch.stack([(2 * px + 1) / w - 1, (2 * py + 1) / h - 1], dim=-1)
                grids.append(g.reshape(b, -1, w, 2).to(srcs[0].dtype))
                del px, py, g

            def library():
                return [F.grid_sample(x, g, mode="bilinear", padding_mode="zeros",
                                      align_corners=False) for x, g in zip(nchw, grids)]

            lib = library()[-1].reshape(b, c, -1, h, w).permute(0, 2, 3, 4, 1)
            row = {"stage": stage_idx + 1, "dtype": tag, "shape": list(got.shape),
                   "views": views, "max_abs": max_abs, "max_rel": rel, "tol_rel": K4_TOL[tag],
                   "library_max_abs_vs_kernel": float((lib.float() - got.float()).abs().max())}
            del got, lib
            row["ms"] = cuda_ms(lambda: [plane_sweep_sample(x, p, ref_p, dv)
                                         for x, p in zip(srcs, src_p)], 10)
            row["ms_per_launch"] = row["ms"] / views
            row["plain_ms"] = cuda_ms(lambda: [plane_sweep_warp(x, p, ref_p, dv)
                                               for x, p in zip(srcs, src_p)], 1, 1)
            row["library_ms"] = cuda_ms(library, 10)
            row["kernel_ms"] = device_ms(lambda: [plane_sweep_sample(x, p, ref_p, dv)
                                                  for x, p in zip(srcs, src_p)],
                                         K4_KERNEL)
            row["library_kernel_ms"] = device_ms(library, "grid_sampler")
            bound, row["bound_by"] = k4_bound_ms(b, dv.shape[1], h, w, c,
                                                 srcs[0].element_size(), dv.dim() == 4)
            row["bound_ms"] = views * bound
            print("K4", json.dumps(row), flush=True)
            check(rel <= K4_TOL[tag], f"K4 stage {stage_idx + 1} {tag}: "
                  f"max rel {rel} > {K4_TOL[tag]}")
            rows.append(row)
            del grids, nchw
            torch.cuda.empty_cache()
    return rows


def k4_variance_bound_ms(b, d, h, w, c, v, elem, per_pixel):
    """The V+1 feature planes read once, the depths, the volume written
    once; per voxel and view ~30 operations of projection and tap weights,
    4 taps x C fma and the two sums 2C; then the mean and variance ~5C."""
    bytes_ = ((v + 1) * b * h * w * c * elem + b * d * (h * w if per_pixel else 1) * 4
              + b * d * h * w * c * elem)
    ops = b * d * h * w * (v * (10 * c + 30) + 5 * c)
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_k4_variance(sample, model, dev):
    """K4's variance entry per stage and dtype on the scene's N views, one
    launch for all of them, against the plain variance cost volume on the
    same inputs in fp32. before_ms is the route it replaced (K4's sampler
    once per view, then the eager fp32 sums), before_kernel_ms that route's
    device time alone (every device activity); library_ms is null: no
    single PyTorch call computes the function."""
    import torch
    from damvsnet_tpu_torch.ops.costvol import variance_cost_volume
    from damvsnet_tpu_torch.ops.kernels.sweep_sampler import (plane_sweep_sample,
                                                              plane_sweep_variance)
    from damvsnet_tpu_torch.ops.warp import plane_sweep_warp
    gen = torch.Generator(device=dev).manual_seed(5)
    feats = {tag: stage_features(sample, model, dev, dtype)
             for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16))}
    rows = []
    for stage_idx in range(3):
        ref_p, src_p = stage_geometry(sample, stage_idx + 1, dev)
        dv = sweep(sample, stage_idx, dev, gen)
        for tag in ("fp32", "bf16"):
            ref, srcs = feats[tag][stage_idx][0], list(feats[tag][stage_idx][1:])
            args = (ref, srcs, ref_p, src_p, dv)
            got = plane_sweep_variance(*args)
            torch.cuda.synchronize()
            want = variance_cost_volume(ref.float(), [x.float() for x in srcs], ref_p, src_p,
                                        dv, warp=plane_sweep_warp)
            diff = (got.float() - want).abs()
            rel = float((diff / (1 + want.abs())).max())
            row = {"stage": stage_idx + 1, "dtype": tag, "shape": list(got.shape),
                   "views": len(srcs), "max_abs": float(diff.max()), "p999_abs": p999(diff),
                   "max_rel": rel, "tol_rel": K4_TOL[tag]}
            del got, want, diff

            def before():
                return variance_cost_volume(*args, warp=plane_sweep_sample)

            row["ms"] = cuda_ms(lambda: plane_sweep_variance(*args), 10)
            row["kernel_ms"] = device_ms(lambda: plane_sweep_variance(*args), K4_VARIANCE_KERNEL)
            row["plain_ms"] = cuda_ms(lambda: variance_cost_volume(*args, warp=plane_sweep_warp),
                                      1, 1)
            row["before_ms"] = cuda_ms(before, 5)
            row["before_kernel_ms"] = device_ms(before, "")
            row["library_ms"] = None
            b, h, w, c = ref.shape
            row["bound_ms"], row["bound_by"] = k4_variance_bound_ms(
                b, dv.shape[1], h, w, c, len(srcs), ref.element_size(), dv.dim() == 4)
            print("K4 variance", json.dumps(row), flush=True)
            check(rel <= K4_TOL[tag], f"K4 variance stage {stage_idx + 1} {tag}: "
                  f"max rel {rel} > {K4_TOL[tag]}")
            rows.append(row)
            torch.cuda.empty_cache()
    return rows


def phase_k4_variance_many_views(model, dev):
    """K4's variance entry with MANY_VIEWS source views: past one launch's
    16 it runs the same variance over K4's sampler, one launch per view;
    against the plain variance cost volume in fp32 at K4_TOL."""
    import torch
    from damvsnet_tpu_torch.ops.costvol import variance_cost_volume
    from damvsnet_tpu_torch.ops.kernels.sweep_sampler import (plane_sweep_sample,
                                                              plane_sweep_variance)
    from damvsnet_tpu_torch.ops.warp import plane_sweep_warp
    for stage_idx, (ref_p, src_p, dv, feats) in enumerate(many_view_features(model, dev)):
        for tag in ("fp32", "bf16"):
            ref, srcs = feats[tag][0], list(feats[tag][1:])
            n0 = (plane_sweep_sample.launches, plane_sweep_variance.launches)
            with torch.no_grad():
                got = plane_sweep_variance(ref, srcs, ref_p, src_p, dv)
                launched = (plane_sweep_sample.launches - n0[0],
                            plane_sweep_variance.launches - n0[1])
                want = variance_cost_volume(ref.float(), [x.float() for x in srcs], ref_p,
                                            src_p, dv, warp=plane_sweep_warp)
            diff = (got.float() - want).abs()
            rel = float((diff / (1 + want.abs())).max())
            row = {"stage": stage_idx + 1, "dtype": tag, "views": MANY_VIEWS,
                   "shape": list(got.shape), "launches": list(launched),
                   "max_abs": float(diff.max()), "max_rel": rel, "tol_rel": K4_TOL[tag]}
            print("K4 variance past 16 views", json.dumps(row), flush=True)
            check(launched == (MANY_VIEWS, 0),
                  f"K4 variance with {MANY_VIEWS} views: launches {launched}")
            check(rel <= K4_TOL[tag], f"K4 variance {MANY_VIEWS} views stage {stage_idx + 1} "
                  f"{tag}: max rel {rel} > {K4_TOL[tag]}")


def phase_variance(sample, model, dev):
    """The variance cascade: timed requests with the launch counters, then
    the depth against the plain versions, with and without geo fusion."""
    import numpy as np
    import torch
    from damvsnet_tpu_torch.infer import DepthRunner
    from damvsnet_tpu_torch.model import CascadeMVSNet
    from damvsnet_tpu_torch.utils.weights import load_bench_weights
    batch = serving_batch(sample)
    rng = float(sample["depth_values"][-1] - sample["depth_values"][0])
    runner = DepthRunner(model, device=dev)
    model.compute_dtype, model.plain = torch.bfloat16, False
    warm_ms, times, out, launches, peak_gib = timed_requests(runner, batch)
    print("variance cascade", json.dumps({"warmup_ms": warm_ms, "request_ms": times,
                                          "peak_mem_gib": peak_gib, "launches": launches}),
          flush=True)
    check_launches("variance cascade", launches, {"prob_volume_stats_fused": 3,
                                                  "plane_sweep_variance": 3,
                                                  "prob_conv3d": 3},
                   REQUESTS)
    depth = out["depth"]
    check(depth.shape == (1, HEIGHT, WIDTH), f"variance depth shape {depth.shape}")
    check(bool(np.isfinite(depth).all()), "non-finite variance depth")
    # information only: the weights were trained with adaptive aggregation
    print("variance cascade vs scene depth", json.dumps({
        "median_abs_err": float(np.median(np.abs(depth - sample["depth"]["stage3"][None]))),
        "depth_range": rng}), flush=True)
    parity = {"geo_fusion": depth_parity(runner, model, batch, rng, depth)}

    no_geo = CascadeMVSNet(ndepths=NDEPTHS, compute_dtype=torch.bfloat16, device=dev,
                           agg_mode="variance", use_geo_fusion=False)
    load_bench_weights(no_geo, SERVING_WEIGHTS)  # warns: geo fusion and the weight nets go
    runner = DepthRunner(no_geo, device=dev)
    parity["no_geo_fusion"] = depth_parity(runner, no_geo, batch, rng, runner(batch)["depth"])
    print("variance cascade vs plain", json.dumps(parity), flush=True)
    for config, by_dtype in parity.items():
        for tag, p in by_dtype.items():
            check(p["p999_abs"] <= p["tol"], f"variance cascade ({config}) {tag}: depth "
                  f"p999 {p['p999_abs']} > {p['tol']}")
    return launches, float(np.mean(times))


@contextlib.contextmanager
def numpy_image_codec():
    """Phase 13's image files through numpy: core/imageio.py's read_rgb and
    write_rgb swapped for raw arrays (np.save) under the same .jpg names
    (``imageio.numpy_codec``); nothing else is replaced."""
    from damvsnet_tpu_torch.core import imageio
    print("image codec: numpy stand-in (core/imageio.py's read_rgb and write_rgb swapped)",
          flush=True)
    with imageio.numpy_codec():
        yield


@contextlib.contextmanager
def fusion_devices(seen):
    """Records the device of every reference view's consistency pass
    (infer/fusion_device.py::consistency_masks) into ``seen``."""
    from damvsnet_tpu_torch.infer import fusion_device
    inner = fusion_device.consistency_masks

    def recorded(depth_ref, *args, **kwargs):
        seen.append(depth_ref.device.type)
        return inner(depth_ref, *args, **kwargs)

    fusion_device.consistency_masks = recorded
    try:
        yield
    finally:
        fusion_device.consistency_masks = inner


def check_depth_files(scene_dir, height=HEIGHT, width=WIDTH, views=EVAL_VIEWS):
    """Every depth file finite at its stage's size; every confidence file
    (the lower stages' upsampled) at full size and in [0, 1] (up to
    CONF_ROUNDING)."""
    import numpy as np
    from damvsnet_tpu_torch.core.pfm import read_pfm
    sizes = {"": (height, width), "_stage2": (height // 2, width // 2),
             "_stage1": (height // 4, width // 4)}
    for v in range(views):
        for sfx, hw in sizes.items():
            depth = read_pfm(os.path.join(scene_dir, f"depth_est/{v:08d}{sfx}.pfm"))[0]
            conf = read_pfm(os.path.join(scene_dir, f"confidence/{v:08d}{sfx}.pfm"))[0]
            check(depth.shape == hw, f"view {v} depth{sfx} shape {depth.shape}, expected {hw}")
            check(bool(np.isfinite(depth).all()), f"view {v} depth{sfx}: non-finite")
            check(conf.shape == (height, width), f"view {v} confidence{sfx} shape {conf.shape}")
            check(bool(((conf >= 0) & (conf <= 1 + CONF_ROUNDING)).all()),
                  f"view {v} confidence{sfx} outside [0, 1]: {conf.min()} .. {conf.max()}")


def fusion_thresholds():
    """fuse_reference_view's defaults (dist_base, rel_diff_base) and the
    last of consistency_masks' dynamic thresholds, the one of the final
    vote."""
    import inspect
    from damvsnet_tpu_torch.infer.fusion_device import consistency_masks, fuse_reference_view
    fuse = inspect.signature(fuse_reference_view).parameters
    dyn_hi = inspect.signature(consistency_masks).parameters["dyn_hi"].default
    return fuse["dist_base"].default, fuse["rel_diff_base"].default, dyn_hi - 1


def source_votes(args, device, margin_ulps=None):
    """Each source's final consistency vote [V, H, W] of one reference view
    (``fuse_reference_view``'s arguments) on ``device``, at
    fuse_reference_view's thresholds. With ``margin_ulps``, (votes, near):
    near [V, H, W] marks where a vote lies within margin_ulps fp32 ulps of
    a threshold (FUSION_MARGIN_ULPS)."""
    import numpy as np
    import torch
    from damvsnet_tpu_torch.infer.fusion_device import (camera_terms, consistency_masks,
                                                        reprojection_errors)
    depth_ref, intr_ref, ext_ref, src_depths, src_intrs, src_exts = args
    dist_base, rel_diff_base, last = fusion_thresholds()

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)
    terms = [m.to(device) for m in camera_terms(intr_ref, ext_ref, src_intrs, src_exts)]
    inputs = (t(depth_ref), t(intr_ref), t(src_depths), t(src_intrs), terms)
    votes = consistency_masks(*inputs, dist_base, rel_diff_base)[1].cpu().numpy()
    if margin_ulps is None:
        return votes
    dist, _, reproj = (x.cpu().numpy() for x in reprojection_errors(*inputs))
    ref = np.asarray(depth_ref, np.float32)
    ys, xs = np.indices(ref.shape, dtype=np.float32)
    near_dist = (np.abs(dist - last * dist_base)
                 <= margin_ulps * np.spacing(np.maximum(xs, ys)))
    near_rel = (np.abs(np.abs(reproj - ref) - last * rel_diff_base * ref)
                <= margin_ulps * np.spacing(ref))
    return votes, near_dist | near_rel


def fusion_errors(args, got, want, got_votes, margin_ulps=FUSION_MARGIN_ULPS):
    """One reference view (``fuse_reference_view``'s arguments ``args``)
    fused on a device under test, ``got``, against the CPU, ``want``: each
    (geo mask, depth_avg). Returns (pixels whose votes differ [H, W],
    depth_avg's relative error [H, W] on every pixel both accept, how many
    pixels were excused). Only where some pixel both accept is off by more
    than FUSION_DEPTH_RTOL are the sources' votes compared, the device's
    from ``got_votes()``: such a pixel is excused, counted as a differing
    vote and not as a depth error, where every source whose vote differs
    lies within margin_ulps of a threshold on the CPU."""
    import numpy as np
    (mask_g, depth_g), (mask_c, depth_c) = got, want
    both = mask_g & mask_c
    d_rel = np.zeros(mask_g.shape)
    d_rel[both] = np.abs(depth_g[both] - depth_c[both]) / np.abs(depth_c[both])
    excused = np.zeros_like(both)
    if (d_rel > FUSION_DEPTH_RTOL).any():
        cpu_votes, near = source_votes(args, "cpu", margin_ulps)
        flipped = got_votes() != cpu_votes
        excused = both & flipped.any(0) & ~(flipped & ~near).any(0)
        d_rel[excused] = 0.0
    return (mask_g != mask_c) | excused, d_rel, int(excused.sum())


def fusion_card_vs_cpu(datapath, outdir, scan, dev, views=EVAL_VIEWS, cpu_refs=None):
    """fuse_reference_view of every reference view on the card and of the
    first ``cpu_refs`` (all if None) on the CPU too, from the written files:
    ``fusion_errors``' share of pixels whose votes differ and depth_avg's
    relative error, each against its limit, and the time of the votes per
    scene on each device (the CPU's from the references it fused)."""
    import numpy as np
    import torch
    from damvsnet_tpu_torch.core.pairs import read_pair_file
    from damvsnet_tpu_torch.core.pfm import read_pfm
    from damvsnet_tpu_torch.infer.fusion_device import fuse_reference_view
    from damvsnet_tpu_torch.infer.fusion_dypcd import read_camera_parameters
    folder = os.path.join(outdir, scan)
    cams = {v: read_camera_parameters(os.path.join(folder, f"cams/{v:08d}_cam.txt"))
            for v in range(views)}
    depths = {v: read_pfm(os.path.join(folder, f"depth_est/{v:08d}.pfm"))[0]
              for v in range(views)}
    pairs = read_pair_file(os.path.join(datapath, scan, "pair.txt"))
    ms = {"cuda": 0.0, "cpu": 0.0}
    share = rel = 0.0
    excused = compared = 0
    for i, (ref, srcs) in enumerate(pairs):
        args = (depths[ref], *cams[ref], np.stack([depths[v] for v in srcs]),
                np.stack([cams[v][0] for v in srcs]), np.stack([cams[v][1] for v in srcs]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fuse_reference_view(*args, device=dev)
        ms["cuda"] += (time.perf_counter() - t0) * 1e3
        if cpu_refs is not None and i >= cpu_refs:
            continue
        t0 = time.perf_counter()
        want = fuse_reference_view(*args, device="cpu")
        ms["cpu"] += (time.perf_counter() - t0) * 1e3
        compared += 1
        differ, d_rel, n = fusion_errors(args, got, want,
                                         lambda args=args: source_votes(args, dev))
        share, rel = max(share, float(differ.mean())), max(rel, float(d_rel.max()))
        excused += n
    ms["cpu"] *= len(pairs) / compared
    return {"votes_ms_per_scene": ms, "cpu_references": compared,
            "votes_differ_share": share, "tol_share": FUSION_MASK_SHARE,
            "depth_avg_max_rel": rel, "tol_rel": FUSION_DEPTH_RTOL,
            "excused_near_threshold": excused, "margin_ulps": FUSION_MARGIN_ULPS}


def phase_test_cli(dev):
    """Phase 13: the test CLI end to end on the card. Returns ({counter:
    launches}, the summary it prints)."""
    import numpy as np
    import torch
    from damvsnet_tpu_torch.cli import test as cli_test
    from damvsnet_tpu_torch.core.ply import read_ply
    from damvsnet_tpu_torch.data.synthetic import export_synthetic_scene
    from damvsnet_tpu_torch.eval.dtu_eval import evaluate_scan
    from damvsnet_tpu_torch.infer.fusion_device import consistency_filter

    scan = "scan_synth"
    with tempfile.TemporaryDirectory() as tmp, numpy_image_codec():
        datapath, outdir = os.path.join(tmp, "data"), os.path.join(tmp, "outputs")
        t0 = time.perf_counter()
        export_synthetic_scene(datapath, scan=scan, height=HEIGHT, width=WIDTH,
                               nviews=EVAL_VIEWS, seed=SEED, num_depth=D0)
        export_s = time.perf_counter() - t0
        testlist = os.path.join(tmp, "list.txt")
        with open(testlist, "w") as f:
            f.write(f"{scan}\n")
        argv = ["--dataset", "general_eval", "--testpath", datapath, "--testlist", testlist,
                "--outdir", outdir, "--num_view", str(NVIEWS), "--numdepth", str(D0),
                "--max_h", str(HEIGHT), "--max_w", str(WIDTH),
                "--ndepths", ",".join(map(str, NDEPTHS)), "--loadckpt", SERVING_WEIGHTS,
                "--filter_method", "consistency", "--conf", EVAL_CONF]
        print("test CLI argv", json.dumps(argv[argv.index("--num_view"):]), flush=True)
        seen, log = [], io.StringIO()
        reset_counters()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with fusion_devices(seen), contextlib.redirect_stdout(log):
            runner = cli_test.main(argv)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = read_counters()
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        print(log.getvalue(), end="", flush=True)
        check_launches("test CLI", launches, {"fused_adaptive_cost_volume": 3,
                                              "prob_volume_stats_fused": 3,
                                              "prob_conv3d": 3}, EVAL_VIEWS)
        check(runner.model.compute_dtype == torch.bfloat16, "the test CLI did not serve in bf16")
        check(seen == [torch.device(dev).type] * EVAL_VIEWS,
              f"the consistency passes ran on {seen}")
        m = re.search(r"([0-9.]+)s/view steady", log.getvalue())
        check(m is not None, "no steady s/view line from the CLI")
        w = re.search(r"write ([0-9.]+)s total", log.getvalue())
        check_depth_files(os.path.join(outdir, scan))

        xyz, rgb = read_ply(os.path.join(outdir, f"{scan}.ply"))
        check(len(xyz) > 0 and bool(np.isfinite(xyz).all()), f"the PLY has {len(xyz)} points")
        gt = np.load(os.path.join(datapath, scan, "gt_points.npy"))
        t0 = time.perf_counter()
        scores = evaluate_scan(xyz.astype(np.float64) * MM_PER_UNIT,
                               gt.astype(np.float64) * MM_PER_UNIT, dst=0.2, max_dist=20.0)
        eval_s = time.perf_counter() - t0
        check(all(math.isfinite(scores[k]) for k in ("acc", "comp", "overall")),
              f"non-finite DTU scores {scores}")

        t0 = time.perf_counter()
        consistency_filter(datapath, outdir, [scan], conf=tuple(map(float, EVAL_CONF.split(","))),
                           device=dev, log_fn=lambda *a: None)
        torch.cuda.synchronize()
        filter_ms = (time.perf_counter() - t0) * 1e3
        fusion = fusion_card_vs_cpu(datapath, outdir, scan, dev)
        fusion["filter_ms_per_scene_card"] = filter_ms
        print("test CLI fusion, card vs CPU", json.dumps(fusion), flush=True)
        check(fusion["votes_differ_share"] <= FUSION_MASK_SHARE,
              f"fusion votes differ on {fusion['votes_differ_share']} of pixels")
        check(fusion["depth_avg_max_rel"] <= FUSION_DEPTH_RTOL,
              f"fused depth relative error {fusion['depth_avg_max_rel']}")
    summary = {"views": EVAL_VIEWS, "s_per_view_steady": float(m.group(1)),
               "write_s_total": float(w.group(1)) if w else None, "cli_s": cli_s,
               "export_s": export_s, "eval_s": eval_s, "peak_mem_gib": peak_gib,
               "points": int(len(xyz)), "launches": launches,
               "fusion_filter_ms_per_scene_card": filter_ms,
               "fusion_votes_ms_per_scene": fusion["votes_ms_per_scene"],
               "dtu_mm": {k: scores[k] for k in ("acc", "comp", "overall", "n_data", "n_stl")}}
    print("test CLI", json.dumps(summary), flush=True)
    return launches, summary


def recipe_argv(script, env):
    """(module, argv) that the recipe ``script`` (a path in this repository)
    hands to ``python -m``: bash runs it from the repository's root with the
    variables of ``env`` set and a stub ``python`` first on PATH, which
    prints its arguments as JSON and exits 0. No shell is parsed here."""
    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as stub_dir:
        stub = os.path.join(stub_dir, "python")
        with open(stub, "w") as f:
            f.write(f"#!{sys.executable}\nimport json, sys\n"
                    "print('RECIPE_ARGV ' + json.dumps(sys.argv[1:]))\n")
        os.chmod(stub, 0o755)
        run_env = {**os.environ, **env, "PATH": stub_dir + os.pathsep + os.environ["PATH"]}
        out = subprocess.run(["bash", os.path.join(repo, script)], env=run_env, cwd=repo,
                             capture_output=True, text=True, timeout=60, check=True).stdout
    lines = [ln for ln in out.splitlines() if ln.startswith("RECIPE_ARGV ")]
    check(len(lines) == 1, f"{script}: {len(lines)} python calls in {out!r}")
    argv = json.loads(lines[0][len("RECIPE_ARGV "):])
    check(argv[:1] == ["-m"], f"{script}: python {argv[:2]} is not a module run")
    return argv[1], argv[2:]


def phase_tnt_recipe(dev):
    """Phase 24: scripts/test_tnt_torch.sh's recipe end to end on the card.
    Returns ({counter: launches}, the summary it prints)."""
    import numpy as np
    import torch
    from damvsnet_tpu_torch.cli import test as cli_test
    from damvsnet_tpu_torch.core.pfm import read_pfm
    from damvsnet_tpu_torch.core.ply import read_ply
    from damvsnet_tpu_torch.data.synthetic import export_synthetic_scene
    from damvsnet_tpu_torch.data.tnt_eval import IMAGE_SIZES, TnTEvalDataset
    from damvsnet_tpu_torch.infer import DepthRunner

    check(IMAGE_SIZES[TNT_SCENE] == (TNT_W, TNT_NATIVE_H), f"{TNT_SCENE}: {IMAGE_SIZES[TNT_SCENE]}")
    with tempfile.TemporaryDirectory() as tmp, numpy_image_codec():
        datapath, outdir = os.path.join(tmp, "tnt"), os.path.join(tmp, "outputs")
        testlist = os.path.join(tmp, "list.txt")
        with open(testlist, "w") as f:
            f.write(f"{TNT_SCENE}\n")
        module, argv = recipe_argv("scripts/test_tnt_torch.sh", {
            "TNT_TESTPATH": datapath, "TNT_LIST": testlist, "CKPT": SERVING_WEIGHTS,
            "OUTDIR": outdir})
        check(module == "damvsnet_tpu_torch.cli.test", f"test_tnt_torch.sh runs {module}")
        # dypcd needs cv2; the photo-mask triplet is Family's own (TANK_CFG)
        argv += ["--filter_method", "consistency"]
        print("TnT recipe argv", json.dumps(argv), flush=True)
        t0 = time.perf_counter()
        # the one cut: the images written at the snapped size, so that the
        # loader's cv2.resize of 1080 rows to 1056 is not reached
        export_synthetic_scene(datapath, scan=TNT_SCENE, height=TNT_H, width=TNT_W,
                               nviews=TNT_VIEWS, seed=SEED, num_depth=D0)
        export_s = time.perf_counter() - t0
        seen, log = [], io.StringIO()
        reset_counters()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with fusion_devices(seen), contextlib.redirect_stdout(log):
            runner = cli_test.main(argv)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = read_counters()
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        print(log.getvalue(), end="", flush=True)
        check_launches("TnT recipe", launches, {"fused_adaptive_cost_volume": 3,
                                                "prob_volume_stats_fused": 3,
                                                "prob_conv3d": 3}, TNT_VIEWS)
        model = runner.model
        check(model.compute_dtype == torch.bfloat16, "the TnT recipe did not serve in bf16")
        check(seen == [torch.device(dev).type] * TNT_VIEWS, f"the consistency passes ran on {seen}")
        m = re.search(r"([0-9.]+)s/view steady", log.getvalue())
        check(m is not None, "no steady s/view line from the CLI")
        w = re.search(r"write ([0-9.]+)s total", log.getvalue())
        scene_dir = os.path.join(outdir, TNT_SCENE)
        check_depth_files(scene_dir, TNT_H, TNT_W, TNT_VIEWS)
        xyz, _ = read_ply(os.path.join(outdir, f"{TNT_SCENE}.ply"))
        conf = read_pfm(os.path.join(scene_dir, "confidence/00000000.pfm"))[0]
        conf_q = [float(np.quantile(conf, q)) for q in (0.5, 0.9, 0.99)]

        # the first view: the CLI's depth file (the kernels, bf16) against the
        # plain route, then both routes in fp32 with TF32 off
        dataset = TnTEvalDataset(datapath, [TNT_SCENE], "test", TNT_VIEWS, D0, 1.0,
                                 max_h=TNT_NATIVE_H, max_w=2048)
        sample = dataset[0]
        check(sample["imgs"].shape == (TNT_VIEWS, TNT_H, TNT_W, 3),
              f"the loader's images {sample['imgs'].shape}")
        batch = serving_batch(sample)
        rng = float(sample["depth_values"][-1] - sample["depth_values"][0])
        depth_file = read_pfm(os.path.join(scene_dir, "depth_est/00000000.pfm"))[0]
        parity = depth_parity(DepthRunner(model, device=dev), model, batch, rng,
                              depth_file[None])
        parity["fp32"]["tol"] = TNT_FP32_TOL
        print("TnT recipe first view vs plain", json.dumps(parity), flush=True)
        for tag, p in parity.items():
            check(p["p999_abs"] <= p["tol"], f"TnT recipe {tag}: depth p999 "
                  f"{p['p999_abs']} > {p['tol']}")
        del model, runner
        torch.cuda.empty_cache()
        fusion = fusion_card_vs_cpu(datapath, outdir, TNT_SCENE, dev, TNT_VIEWS,
                                    TNT_CPU_REFS)
        print("TnT recipe fusion, card vs CPU", json.dumps(fusion), flush=True)
        check(fusion["votes_differ_share"] <= FUSION_MASK_SHARE,
              f"fusion votes differ on {fusion['votes_differ_share']} of pixels")
        check(fusion["depth_avg_max_rel"] <= FUSION_DEPTH_RTOL,
              f"fused depth relative error {fusion['depth_avg_max_rel']}")
    summary = {"scene": TNT_SCENE, "views": TNT_VIEWS, "size": [TNT_W, TNT_H],
               "first_view_confidence_q50_q90_q99": conf_q,
               "s_per_view_steady": float(m.group(1)),
               "write_s_total": float(w.group(1)) if w else None, "cli_s": cli_s,
               "export_s": export_s, "peak_mem_gib": peak_gib, "points": int(len(xyz)),
               "launches": launches, "fusion_votes_ms_per_scene": fusion["votes_ms_per_scene"],
               "parity": parity}
    print("TnT recipe", json.dumps(summary), flush=True)
    check(len(xyz) > 0 and bool(np.isfinite(xyz).all()), f"the PLY has {len(xyz)} points")
    return launches, summary


def accuracy_chain():
    """scripts/e2e_synthetic_torch.py as a module."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                        "e2e_synthetic_torch.py")
    spec = importlib.util.spec_from_file_location("e2e_synthetic_torch", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_accuracy_chain():
    """Phase 25: the accuracy chain's ``main`` in this process (training
    from scratch, the weights-only restore, serving the held-out scene, the
    device fusion, the DTU protocol) with every launch counter set to 0 just
    before and read just after. Returns ({counter: launches}, summary)."""
    import torch
    chain = accuracy_chain()
    with tempfile.TemporaryDirectory() as tmp:
        argv = CHAIN_ARGV + ["--workdir", tmp, "--out", os.path.join(tmp, "accuracy.json")]
        print("accuracy chain argv", json.dumps(CHAIN_ARGV), flush=True)
        log = io.StringIO()
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            report = chain.main(argv)
        torch.cuda.synchronize()
        chain_s = time.perf_counter() - t0
        launches = read_counters()
    # the per-step log lines stay out of the smoke's output
    print("".join(line for line in log.getvalue().splitlines(keepends=True)
                  if " iter " not in line), end="", flush=True)
    views = report["inference"]["views"]
    check_launches("accuracy chain", launches, {"fused_adaptive_cost_volume": 3,
                                                "prob_volume_stats_fused": 3,
                                                "prob_conv3d": 3}, views)
    curve = [e["loss"] for e in report["train_curve"]]
    check(len(curve) == 2 and curve[1] <= CHAIN_LOSS_DROP * curve[0],
          f"accuracy chain: epoch losses {curve}, the second above {CHAIN_LOSS_DROP} x the first")
    check(report["checkpoint"]["restored_bitwise"],
          "accuracy chain: the restored weights or statistics differ from the trained ones")
    check(report["depth"]["finite"], "accuracy chain: non-finite depth error")
    check(report["fusion"]["points_device_backend"] > 0, "accuracy chain: empty device cloud")
    summary = {"chain_s": chain_s, "epoch_loss": curve, "train_steps": report["train_steps"],
               "train_step_ms_median": report["train_step_ms_median"],
               "s_per_view": report["inference"]["sec_per_view"], "views": views,
               "peak_gib": report["peak_gib"], "depth": report["depth"],
               "fusion": report["fusion"], "dtu_mm": report["dtu_protocol"],
               "reduced": report["reduced"], "launches": launches}
    print("accuracy chain", json.dumps(summary), flush=True)
    return launches, summary


def device_profile(fn, iters=3):
    """(device ms, device activities) per call of ``fn``: every kernel,
    copy and fill on the card under torch.profiler (not the device-side
    copies of the port's spans, which are annotations)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace can come back without its device events
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation and not e.name.startswith("Activity Buffer")]
        if events:
            return (sum(e.time_range.elapsed_us() for e in events) / 1e3 / iters,
                    len(events) / iters)
    raise RuntimeError("check failed: three traces saw no device activity")


def seeded_model(dev, seeded, **config):
    """A bf16 serving model of ``config``: the trained weights, the modules
    named in ``seeded`` from the seeded init (torch.manual_seed(SEED)),
    said on a line of its own."""
    import torch
    from damvsnet_tpu_torch.model import CascadeMVSNet
    from damvsnet_tpu_torch.utils.weights import load_bench_weights
    torch.manual_seed(SEED)
    model = CascadeMVSNet(ndepths=NDEPTHS, compute_dtype=torch.bfloat16, device=dev, **config)
    load_bench_weights(model, SERVING_WEIGHTS, seeded)
    print(f"weights {json.dumps(config)}: {SERVING_WEIGHTS}; seeded init "
          f"(torch.manual_seed({SEED})) for {', '.join(seeded)}", flush=True)
    return model


def phase_fmt_serving(sample, dev):
    """Phase 14. Returns ({counter: launches}, mean request ms, summary)."""
    import numpy as np
    import torch
    from damvsnet_tpu_torch.infer import DepthRunner
    model = seeded_model(dev, ("FMT_with_pathway",), use_fmt=True)
    batch = serving_batch(sample)
    rng = float(sample["depth_values"][-1] - sample["depth_values"][0])
    runner = DepthRunner(model, device=dev)
    warm_ms, times, out, launches, peak_gib = timed_requests(runner, batch)
    check_launches("FMT cascade", launches, {"fused_adaptive_cost_volume": 3,
                                             "prob_volume_stats_fused": 3,
                                             "prob_conv3d": 3}, REQUESTS)
    depth = out["depth"]
    check(depth.shape == (1, HEIGHT, WIDTH), f"FMT depth shape {depth.shape}")
    check(bool(np.isfinite(depth).all()), "non-finite FMT depth")
    parity = depth_parity(runner, model, batch, rng, depth)
    floor = bf16_floor(runner, model, batch)
    parity["bf16"]["floor_1ulp_p999"] = floor
    parity["bf16"]["tol"] = max(parity["bf16"]["tol"], BF16_FLOOR_FACTOR * floor)
    imgs = torch.as_tensor(batch["imgs"], device=dev)
    with torch.inference_mode():
        feats = model._view_features(imgs)
        fmt_ms, fmt_activities = device_profile(
            lambda: model.FMT_with_pathway(feats, torch.bfloat16))
    request_ms, request_activities = device_profile(lambda: runner(batch))
    summary = {"warmup_ms": warm_ms, "request_ms": times, "peak_mem_gib": peak_gib,
               "launches": launches, "parity": parity,
               "fmt_device_ms": fmt_ms, "fmt_device_activities": fmt_activities,
               "request_device_ms": request_ms,
               "request_device_activities": request_activities,
               "fmt_share_of_request_device_ms": fmt_ms / request_ms,
               "median_abs_err_vs_scene": float(np.median(np.abs(
                   depth - sample["depth"]["stage3"][None])))}
    print("FMT cascade", json.dumps(summary), flush=True)
    for tag, p in parity.items():
        check(p["p999_abs"] <= p["tol"], f"FMT cascade {tag}: depth p999 "
              f"{p['p999_abs']} > {p['tol']}")
    return launches, float(np.mean(times)), summary


def phase_train_variants(dev):
    """Phase 15. Returns ({counter: launches}, mean step ms, peak GiB)."""
    import torch
    from damvsnet_tpu_torch.train.loop import batch_to_device
    config = {"fused_train": True, "use_fmt": True, "grad_method": "undetach"}
    print(f"weights {json.dumps(config)}: {SERVING_WEIGHTS}; seeded init "
          f"(torch.manual_seed({SEED})) for FMT_with_pathway", flush=True)
    model, state, step, batches, start, launches, mean_ms, peak_gib = timed_training(
        dev, "training_variants", VARIANT_STEPS, seeded=("FMT_with_pathway",), **config)
    check_launches("variant training", launches, {"fused_adaptive_cost_volume": 3,
                                                  "fused_adaptive_cost_volume_backward": 3},
                   VARIANT_STEPS)
    del state, step
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model.compute_dtype = torch.float32
    batch = batch_to_device(batches[1], dev)
    results = {}
    for plain in (False, True):
        model.load_state_dict(start)
        model.train()
        results[plain] = grads_of_one_step(model, batch, plain)
        torch.cuda.empty_cache()
    check_step_parity("variant train vs plain (fp32)", results[False], results[True])
    model.load_state_dict(start)
    model.grad_method = "detach"
    _, detached = grads_of_one_step(model, batch, False)
    undetached = results[False][1]

    def rel(prefix):
        keys = [k for k in undetached if k.startswith(prefix)]
        num = sum(float(((undetached[k] - detached[k]) ** 2).sum()) for k in keys)
        return math.sqrt(num / max(sum(float((detached[k] ** 2).sum()) for k in keys), 1e-30))
    handoff = {"stage1_costreg_rel_l2": rel("cost_regularization.0."),
               "stage3_costreg_rel_l2": rel("cost_regularization.2."),
               "fmt_rel_l2": rel("FMT_with_pathway.")}
    print("variant train, undetached vs detached gradients (fp32)", json.dumps(handoff),
          flush=True)
    check(handoff["stage1_costreg_rel_l2"] > UNDETACH_MIN_CHANGE,
          f"the undetached handoff did not change stage 1's gradients: {handoff}")
    del model
    torch.cuda.empty_cache()
    return launches, mean_ms, peak_gib


@contextlib.contextmanager
def stats_changed(change):
    """The serving stats, plain and K2 alike, with their output replaced by
    ``change(out, samples, stage_idx)``."""
    from damvsnet_tpu_torch.model import cascade
    saved = cascade.prob_volume_stats, cascade.prob_volume_stats_fused

    def changed(fn):
        def stats(cost, samples):
            return change(fn(cost, samples), samples, NDEPTHS.index(cost.shape[1]))
        return stats
    cascade.prob_volume_stats, cascade.prob_volume_stats_fused = map(changed, saved)
    try:
        yield
    finally:
        cascade.prob_volume_stats, cascade.prob_volume_stats_fused = saved


def depth_off_by_one(out, samples, stage_idx):
    """A planted fault: stage 2's depth regressed against its hypotheses
    read one off (hypothesis i as i + 1, the last one interval past the
    end), so stage 3 samples a band one stage-2 hypothesis off."""
    import torch
    if stage_idx != 1:
        return out
    shifted = torch.cat([samples[:, 1:], 2 * samples[:, -1:] - samples[:, -2:-1]], 1)
    return dict(out, depth=(out["prob_volume"] * shifted).sum(1))


@contextlib.contextmanager
def volume_changed(change):
    """K1 and its plain version with ``change(fn, args, stage_idx)`` in place
    of ``fn(*args)``: the cost volume a stage hands to its regularizer."""
    from damvsnet_tpu_torch.model import cascade
    saved = cascade.fused_adaptive_cost_volume, cascade.fused_adaptive_cost_volume_plain

    def changed(fn):
        def costvol(*args):
            return change(fn, args, NDEPTHS.index(args[4].shape[1]))
        return costvol
    cascade.fused_adaptive_cost_volume, cascade.fused_adaptive_cost_volume_plain = map(
        changed, saved)
    try:
        yield
    finally:
        cascade.fused_adaptive_cost_volume, cascade.fused_adaptive_cost_volume_plain = saved


def one_ulp_volume(fn, args, stage_idx):
    """Every fp32 entry of the volume moved by one ulp, up or down (seeded),
    before the cascade casts it to the compute dtype."""
    import torch
    vol = fn(*args).float()
    g = torch.Generator(device=vol.device).manual_seed(stage_idx)
    sign = torch.randint(0, 2, vol.shape, generator=g, device=vol.device).float() * 2 - 1
    return vol * (1.0 + 2.0 ** -23 * sign)


def phase_variant_serving(sample, dev):
    """Phase 16. Returns ({counter: launches}, mean request ms, peak GiB, summary)."""
    import numpy as np
    import torch
    from damvsnet_tpu_torch.infer import DepthRunner
    model = seeded_model(dev, ("feature", "cost_regularization", "refine_network"),
                         reg_mode="georeg", refine=True, arch_mode="unet")
    batch = serving_batch(sample)
    rng = float(sample["depth_values"][-1] - sample["depth_values"][0])
    runner = DepthRunner(model, device=dev)
    warm_ms, times, out, launches, peak_gib = timed_requests(runner, batch)
    check_launches("GeoReg/refine/U-Net cascade", launches,
                   {"fused_adaptive_cost_volume": 3, "prob_volume_stats_fused": 3}, REQUESTS)
    check(bool(np.isfinite(out["depth"]).all()), "non-finite GeoReg depth")
    args = (runner._tensor(batch["imgs"]),
            {k: runner._tensor(v) for k, v in batch["proj_matrices"].items()},
            runner._tensor(batch["depth_values"]))
    keys = ("depth", "refined_depth")

    def run(plain, dtype, change=None, volume=None):
        model.plain, model.compute_dtype = plain, dtype
        with torch.inference_mode(), (stats_changed(change) if change
                                      else contextlib.nullcontext()), (
                volume_changed(volume) if volume else contextlib.nullcontext()):
            o = model(*args)
            return {k: o[k].float().cpu().numpy() for k in keys}

    def p999(a, b):
        diff = np.abs(a - b)
        return {"p999_abs": float(np.quantile(diff, 0.999)), "max_abs": float(diff.max())}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    parity, residual, plain = {}, None, {}
    for tag, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        got, want = run(False, dtype), run(True, dtype)
        plain[tag] = want
        if residual is None:  # what the seeded RefineNet adds, on the kernels in bf16
            r = np.abs(got["refined_depth"] - got["depth"])
            residual = {"mean_abs": float(r.mean()), "nonzero_share": float((r > 0).mean())}
        parity[tag] = {}
        tol = DEPTH_TOL_SHARE * rng if tag == "bf16" else GEOREG_FP32_TOL
        for key in keys:
            check(got[key].shape == (1, HEIGHT, WIDTH) and bool(np.isfinite(got[key]).all()),
                  f"GeoReg {tag} {key}: shape {got[key].shape} or non-finite")
            parity[tag][key] = {**p999(got[key], want[key]), "tol": tol}
    # bf16 (GEOREG_BF16_FLOOR): the plain route's own move under one-ulp fp32
    # changes of the cost volumes it hands its regularizers sets the limit.
    # A planted fault must fail it, and fp32's: stage 2's depth regressed
    # against its hypotheses read one off
    floor = run(True, torch.bfloat16, volume=one_ulp_volume)
    faults = {tag: run(False, dtype, change=depth_off_by_one)
              for tag, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32))}
    for key in keys:
        p = parity["bf16"][key]
        p["floor_volume_1ulp_p999"] = p999(floor[key], plain["bf16"][key])["p999_abs"]
        p["tol"] = max(p["tol"], BF16_FLOOR_FACTOR * p["floor_volume_1ulp_p999"])
        for tag, fault in faults.items():
            parity[tag][key]["fault_depth_off_by_one_p999"] = p999(
                fault[key], plain[tag][key])["p999_abs"]
    summary = {"warmup_ms": warm_ms, "request_ms": times, "peak_mem_gib": peak_gib,
               "launches": launches, "parity": parity, "refine_residual": residual}
    print("GeoReg/refine/U-Net cascade", json.dumps(summary), flush=True)
    for tag in ("bf16", "fp32"):
        for key in keys:
            p = parity[tag][key]
            check(p["p999_abs"] <= p["tol"], f"GeoReg/refine/U-Net {tag} {key}: p999 "
                  f"{p['p999_abs']} > {p['tol']}")
            check(p["fault_depth_off_by_one_p999"] > p["tol"], f"GeoReg {tag} {key}: the "
                  f"planted fault (stage 2's depth one hypothesis off) moved it by p999 "
                  f"{p['fault_depth_off_by_one_p999']}, within the limit {p['tol']}")
    del model, runner
    torch.cuda.empty_cache()
    return launches, float(np.mean(times)), peak_gib, summary


# ---- phases 17-20: ranks, each a process of this script on the one card ----
#
# NCCL refuses two ranks on one card, so the two-rank phases run gloo over
# CUDA tensors on cuda:0 (gloo copies each collective through the host);
# the ranks share the card's SMs, so their step times record the path and
# are no scaling figure. Phase 17 also steps once under NCCL at world size
# 1. Each child is a fresh process (``python3 chip_smoke.py --rank-child
# <phase> <workdir>``) with torchrun's environment, a time limit of its own
# and gloo's timeout; it prints its results as the last line of its output
# ("RESULT {json}"), its launch counters among them.


def free_port():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn_ranks(phase, workdir, world=RANKS, distributed=True):
    """``world`` children of this script for ``phase``, started together;
    returns their RESULT dicts in rank order. A child that fails, or
    outlasts CHILD_TIMEOUT, fails the smoke with the tail of its output."""
    port = free_port()
    procs = []
    for rank in range(world):
        env = {**os.environ, "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))}
        if distributed:
            env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        log = open(os.path.join(workdir, f"{phase}_rank{rank}.log"), "w")
        procs.append((subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank-child",
                                        phase, workdir], env=env, stdout=log,
                                       stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + CHILD_TIMEOUT
    try:
        # a child that fails ends the others (they would wait in a collective)
        while any(p.poll() is None for p, _ in procs):
            if time.monotonic() > deadline or any(p.poll() not in (None, 0) for p, _ in procs):
                break
            time.sleep(0.5)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
    results, failed = [], []
    for rank, (p, log) in enumerate(procs):
        text = open(log.name).read()
        lines = [ln for ln in text.splitlines() if ln.startswith("RESULT ")]
        if p.returncode != 0 or not lines:
            print(f"--- {phase} rank {rank}, exit {p.returncode}, its output's tail:\n"
                  f"{text[-4000:]}", flush=True)
            failed.append(f"rank {rank} exited with {p.returncode}")
        else:
            results.append(json.loads(lines[-1][len("RESULT "):]))
    check(not failed, f"{phase}: {', '.join(failed)}")
    return results


def child_device(backend="gloo"):
    import torch
    from damvsnet_tpu_torch.parallel import local_device, maybe_initialize_distributed
    rank, world = maybe_initialize_distributed(backend, timeout=GLOO_TIMEOUT)
    dev = local_device()
    torch.cuda.set_device(dev)
    return rank, world, dev


def collective_profile(fn):
    """Host time and count of every collective in one call of ``fn`` (the
    profiler's CPU ops whose names hold a collective's), and the call's
    host time under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    keys = ("allreduce", "allgather", "all_reduce", "all_gather", "broadcast", "barrier",
            "send", "recv")
    rows = {e.key: {"count": e.count, "cpu_ms": e.cpu_time_total / 1e3}
            for e in prof.key_averages() if any(k in e.key.lower() for k in keys)}
    return {"profiled_wall_ms": wall, "ops": rows}


def train_rows(i, rows):
    """Rows ``rows`` of global training batch i (samples TRAIN_B*i + row)."""
    return train_batch([TRAIN_B * i + r for r in rows])


def ddp_model(dev, dtype):
    import torch
    from damvsnet_tpu_torch.model import CascadeMVSNet
    from damvsnet_tpu_torch.utils.weights import load_bench_weights
    torch.manual_seed(SEED)
    model = CascadeMVSNet(ndepths=NDEPTHS, compute_dtype=dtype, device=dev, fused_train=True)
    load_bench_weights(model, SERVING_WEIGHTS)
    return model


def fp32_step_result(model, batch, dev, mesh):
    """One fp32 step (TF32 off) under SGD with lr 0 through make_train_step:
    (metrics, {name: gradient}, {running statistics}) on the host."""
    import torch
    from damvsnet_tpu_torch.train.loop import make_train_step
    from damvsnet_tpu_torch.train.state import TrainState
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.0))
    metrics = make_train_step(device=dev, mesh=mesh)(state, batch)
    metrics.pop("_images")
    return ({k: float(v) for k, v in metrics.items()},
            {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
            {k: v.detach().cpu() for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))})


def child_ddp_train(workdir, backend="gloo"):
    """Phase 17, a rank: 1 warm and TRAIN_STEPS timed bf16 fused steps on
    its rows of each global batch, the counters set to 0 just before and
    read just after; one more step profiled for its collectives; then one
    fp32 step from the trained weights (rank 0 saves its gradients).
    backend None: the default, NCCL, a card a rank."""
    import torch
    from damvsnet_tpu_torch.parallel import batch_rows, make_mesh
    from damvsnet_tpu_torch.train.loop import make_train_step
    from damvsnet_tpu_torch.train.schedule import make_optimizer
    from damvsnet_tpu_torch.train.state import TrainState
    rank, world, dev = child_device(backend)
    mesh = make_mesh()
    rows = batch_rows(TRAIN_B, mesh.data_rank, mesh.data)
    model = ddp_model(dev, torch.bfloat16)
    optimizer, scheduler = make_optimizer(model.parameters(), 1e-3, "10,12,14:2",
                                          iters_per_epoch=1000)
    state = TrainState(model, optimizer, scheduler)
    step = make_train_step(device=dev, mesh=mesh)
    batches = [train_rows(i, rows) for i in range(TRAIN_STEPS + 1)]
    t0 = time.perf_counter()
    step(state, batches[0])
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    reset_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    for batch in batches[1:]:
        t0 = time.perf_counter()
        metrics = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        metrics.pop("_images")
        losses.append({k: float(v) for k, v in metrics.items()})
    launches = read_counters()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    collectives = collective_profile(lambda: step(state, batches[1]))
    del state, step, optimizer, scheduler, model
    torch.cuda.empty_cache()
    metrics, grads, stats = fp32_step_result(ddp_model(dev, torch.float32), batches[1], dev, mesh)
    if rank == 0:
        torch.save({"metrics": metrics, "grads": grads, "stats": stats},
                   os.path.join(workdir, "ddp_fp32.pt"))
    return {"rank": rank, "world": world, "rows": rows, "warmup_ms": warm_ms,
            "step_ms": step_ms, "metrics": losses, "launches": launches,
            "peak_mem_gib": peak_gib, "collectives": collectives}


def child_nccl_step(workdir):
    """Phase 17, NCCL at world size 1: the default backend initializes, a
    fused bf16 step runs on the rank's card, and an all-reduce and a
    barrier pass over NCCL."""
    import torch
    import torch.distributed as dist
    from damvsnet_tpu_torch.parallel import make_mesh
    from damvsnet_tpu_torch.train.loop import make_train_step
    from damvsnet_tpu_torch.train.state import TrainState
    rank, world, dev = child_device(backend=None)
    model = ddp_model(dev, torch.bfloat16)
    state = TrainState(model, torch.optim.Adam(model.parameters(), lr=1e-4))
    reset_counters()
    metrics = make_train_step(device=dev, mesh=make_mesh())(state, train_rows(0, range(2)))
    launches = read_counters()
    loss = metrics["loss"].float().reshape(1)
    dist.all_reduce(loss)
    dist.barrier()
    torch.cuda.synchronize()
    return {"backend": dist.get_backend(), "world": world, "loss": float(loss),
            "launches": launches}


def run_train_cli(logdir, extra):
    """The training CLI on the synthetic scenes at 128x160, 8 samples, with
    the flags ``extra``; returns its step, epoch and log."""
    import functools
    from damvsnet_tpu_torch import data as port_data
    from damvsnet_tpu_torch.cli import train as cli_train
    from damvsnet_tpu_torch.data import SyntheticDataset
    port_data._REGISTRY["synthetic"] = functools.partial(
        SyntheticDataset, height=CLI_TRAIN_H, width=CLI_TRAIN_W, length=CLI_TRAIN_SAMPLES)
    argv = ["--dataset", "synthetic", "--fused_train", "--batch_size", str(TRAIN_B),
            "--nviews", str(NVIEWS), "--numdepth", str(D0),
            "--ndepths", ",".join(map(str, NDEPTHS)), "--num_workers", "0", "--summary_freq", "1",
            "--logdir", logdir] + extra
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        trainer = cli_train.main(argv)
    print(log.getvalue(), flush=True)
    return {"step": trainer.state.step, "epoch": trainer.state.epoch, "log": log.getvalue()}


def child_train_cli(workdir):
    """Phase 18, a rank (or, without a process group, the 1-rank resume)."""
    if "WORLD_SIZE" not in os.environ:
        extra = ["--epochs", "2", "--resume"]
    else:
        extra = ["--epochs", "1", "--dist_backend", "gloo", "--profile_dir",
                 os.path.join(workdir, "train_prof")]
    return run_train_cli(os.path.join(workdir, "train_run"), extra)


def child_slab_cli(workdir):
    """Phase 23, a rank of the 2x2 mesh (or, without a process group, the
    1-rank resume)."""
    if "WORLD_SIZE" not in os.environ:
        extra = ["--epochs", "2", "--resume"]
    else:
        extra = ["--epochs", "1", "--dist_backend", "gloo", "--mesh_data", "2",
                 "--mesh_space", "2"]
    return run_train_cli(os.path.join(workdir, "slab_run"), extra)


def record_scenes():
    """(the scenes this process built a loader for, the context that
    records them): data.find_dataset_def wrapped."""
    from damvsnet_tpu_torch import data
    owned, inner = [], data.find_dataset_def

    def recording(name):
        cls = inner(name)

        def build(datapath, scenes, *args, **kwargs):
            owned.extend(scenes)
            return cls(datapath, scenes, *args, **kwargs)
        return build

    @contextlib.contextmanager
    def ctx():
        data.find_dataset_def = recording
        try:
            yield
        finally:
            data.find_dataset_def = inner
    return owned, ctx()


def scan_cli_argv(datapath, testlist, outdir):
    return ["--dataset", "general_eval", "--testpath", datapath, "--testlist", testlist,
            "--outdir", outdir, "--num_view", str(NVIEWS), "--numdepth", str(D0),
            "--max_h", str(HEIGHT), "--max_w", str(WIDTH),
            "--ndepths", ",".join(map(str, NDEPTHS)), "--loadckpt", SERVING_WEIGHTS,
            "--filter_method", "consistency", "--conf", EVAL_CONF]


def child_test_cli(workdir):
    """Phase 19, a rank: the test CLI over the list, scan-parallel."""
    import torch
    rank, world, dev = child_device()
    owned, recording = record_scenes()
    log = io.StringIO()
    reset_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with numpy_image_codec(), recording, contextlib.redirect_stdout(log):
        cli_test_main(scan_cli_argv(os.path.join(workdir, "scan_data"),
                                    os.path.join(workdir, "scan_list.txt"),
                                    os.path.join(workdir, "scan_mp")) + ["--dist_backend", "gloo"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = read_counters()
    print(log.getvalue(), flush=True)
    m = re.search(r"([0-9.]+)s/view steady", log.getvalue())
    return {"rank": rank, "scenes": owned, "launches": launches, "cli_s": cli_s,
            "s_per_view_steady": float(m.group(1)) if m else None,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def cli_test_main(argv):
    from damvsnet_tpu_torch.cli import test as cli_test
    return cli_test.main(argv)


def child_fmt_sp(workdir):
    """Phase 20, a rank: phase 14's request on the seeded FMT model whose
    attention runs sequence-parallel over the two ranks: 1 warm-up and
    REQUESTS timed requests with the counters, one profiled for its
    collectives, then the depth in bf16 and fp32 (TF32 off) saved, and a
    control: the fp32 depth once more with the attention's all-reduce left
    out (a planted fault: each rank attends to its own half of the tokens
    only), which phase 20's fp32 limit must refuse."""
    import numpy as np
    import torch
    from damvsnet_tpu_torch.data.synthetic import make_synthetic_sample
    from damvsnet_tpu_torch.infer import DepthRunner
    from damvsnet_tpu_torch.parallel import make_mesh
    from damvsnet_tpu_torch.model import CascadeMVSNet
    from damvsnet_tpu_torch.utils.weights import load_bench_weights
    rank, world, dev = child_device()
    group = make_mesh(data=1, space=world).space_group
    torch.manual_seed(SEED)  # phase 14's seeded FMT, on every rank
    model = CascadeMVSNet(ndepths=NDEPTHS, compute_dtype=torch.bfloat16, device=dev,
                          use_fmt=True, fmt_sp_group=group)
    load_bench_weights(model, SERVING_WEIGHTS, ("FMT_with_pathway",))
    sample = make_synthetic_sample(height=HEIGHT, width=WIDTH, nviews=NVIEWS, ndepths=D0,
                                   with_gt=True, seed=SEED)
    batch = serving_batch(sample)
    runner = DepthRunner(model, device=dev)
    warm_ms, times, out, launches, peak_gib = timed_requests(runner, batch)
    collectives = collective_profile(lambda: runner(batch))
    depth = {"bf16": out["depth"]}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model.compute_dtype = torch.float32
    depth["fp32"] = runner(batch)["depth"]
    from damvsnet_tpu_torch.parallel import fmt_sp
    sound = fmt_sp.all_reduce_sum
    fmt_sp.all_reduce_sum = lambda partial, group: partial
    try:
        depth["fp32_fault"] = runner(batch)["depth"]
    finally:
        fmt_sp.all_reduce_sum = sound
    if rank == 0:
        np.savez(os.path.join(workdir, "fmt_sp_depth.npz"), **depth)
    return {"rank": rank, "tokens_per_rank": (HEIGHT // 4) * (WIDTH // 4) // world,
            "warmup_ms": warm_ms, "request_ms": times, "launches": launches,
            "peak_mem_gib": peak_gib, "collectives": collectives}


# ---- phases 21-23: the depth-slab axis, ranks of this script on the one card ----
#
# Each rank of a space group holds one slab of every stage's depth
# hypotheses (parallel/slab.py); the ranks share the card's SMs and gloo
# copies every halo and gather through the host, so no time here is a
# scaling figure: a record of the path.


def slab_model(dev, dtype, mesh, **config):
    """A model of ``config`` on the trained weights, its hypotheses cut
    over the mesh's space group."""
    import torch
    from damvsnet_tpu_torch.model import CascadeMVSNet
    from damvsnet_tpu_torch.utils.weights import load_bench_weights
    torch.manual_seed(SEED)
    model = CascadeMVSNet(ndepths=NDEPTHS, compute_dtype=dtype, device=dev,
                          slab_group=mesh.space_group,
                          slab_stats_group=mesh.slab_stats_group, **config)
    load_bench_weights(model, SERVING_WEIGHTS)  # variance: warns, the weight nets go
    return model


@contextlib.contextmanager
def kernel_depths():
    """{wrapper: [D of each call]} while the block runs: the cascade's K1,
    K4-variance and K2 wrappers wrapped to record the depth of the volume
    each call produces (the wrappers count their launches as ever)."""
    from damvsnet_tpu_torch.model import cascade
    names = ("fused_adaptive_cost_volume", "plane_sweep_variance", "prob_volume_stats_fused")
    saved = {n: getattr(cascade, n) for n in names}
    seen = {}

    def spy(name, fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            volume = out["prob_volume"] if isinstance(out, dict) else out
            seen.setdefault(name, []).append(int(volume.shape[1]))
            return out
        return call

    for n, fn in saved.items():
        setattr(cascade, n, spy(n, fn))
    try:
        yield seen
    finally:
        for n, fn in saved.items():
            setattr(cascade, n, fn)


@contextlib.contextmanager
def zeroed_halos():
    """The planted fault: every halo exchange returns zeros where the
    neighbours' planes belong."""
    import torch
    from damvsnet_tpu_torch.parallel import slab

    def zero(x, dim, before, after, group):
        shape = list(x.shape)
        pads = []
        for k in (before, after):
            shape[dim] = k
            pads.append(x.new_zeros(shape))
        return torch.cat([pads[0], x, pads[1]], dim)

    sound, slab.exchange_halo = slab.exchange_halo, zero
    try:
        yield
    finally:
        slab.exchange_halo = sound


@contextlib.contextmanager
def level_depths_held(model):
    """Fills the list it yields, when the block ends, with each stage's
    CostRegNet level depths as this rank held them: the D of the output of
    the block that writes each level (conv0, conv1, conv3, conv5), seen
    through ``slab.run_block``."""
    from damvsnet_tpu_torch.parallel import slab
    seen, held, sound = {}, [], slab.run_block

    def run_block(block, x, *args):
        y = sound(block, x, *args)
        seen[id(block)] = int(y.shape[2])
        return y

    slab.run_block = run_block
    try:
        yield held
    finally:
        slab.run_block = sound
        held += [[seen.get(id(getattr(r, n))) for n in ("conv0", "conv1", "conv3", "conv5")]
                 for r in model.cost_regularization]


def digest(tensors):
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def stage_handoffs(model, batch, dev):
    """A digest per stage of what the next stage reads: its depth, sigma and
    hypotheses."""
    import torch
    with torch.inference_mode():
        out = model(torch.as_tensor(batch["imgs"], device=dev),
                    {k: torch.as_tensor(v, device=dev) for k, v in batch["proj_matrices"].items()},
                    torch.as_tensor(batch["depth_values"], device=dev))
    return {s: digest([out[s]["depth"], out[s]["variance"], out[s]["depth_values"]])
            for s in ("stage1", "stage2", "stage3")}


def child_slab_serve(workdir):
    """Phase 21, a rank: phase 5's request with the hypotheses cut over the
    ranks: 1 warm-up and REQUESTS timed requests with the counters and the
    depth of each kernel call, each CostRegNet level's local D, the stage
    handoffs' digests, one request profiled for its collectives; the depth
    in fp32 (TF32 off), and again with the halos zeroed (the planted
    fault); then one variance request with the counters."""
    import numpy as np
    import torch
    from damvsnet_tpu_torch.data.synthetic import make_synthetic_sample
    from damvsnet_tpu_torch.infer import DepthRunner
    from damvsnet_tpu_torch.parallel import make_mesh
    rank, world, dev = child_device()
    mesh = make_mesh(data=1, space=world)
    sample = make_synthetic_sample(height=HEIGHT, width=WIDTH, nviews=NVIEWS, ndepths=D0,
                                   with_gt=True, seed=SEED)
    batch = serving_batch(sample)
    model = slab_model(dev, torch.bfloat16, mesh)
    runner = DepthRunner(model, device=dev)
    with kernel_depths() as seen, level_depths_held(model) as local:
        warm_ms, times, out, launches, peak_gib = timed_requests(runner, batch)
    handoffs = stage_handoffs(model, batch, dev)
    collectives = collective_profile(lambda: runner(batch))
    depth = {"bf16": out["depth"]}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model.compute_dtype = torch.float32
    depth["fp32"] = runner(batch)["depth"]
    with zeroed_halos():
        depth["fp32_fault"] = runner(batch)["depth"]
    del runner, model
    torch.cuda.empty_cache()
    vmodel = slab_model(dev, torch.bfloat16, mesh, agg_mode="variance")
    vrunner = DepthRunner(vmodel, device=dev)
    reset_counters()
    with kernel_depths() as vseen:
        t0 = time.perf_counter()
        depth["variance_bf16"] = vrunner(batch)["depth"]
        var_ms = (time.perf_counter() - t0) * 1e3
    var_launches = read_counters()
    if rank == 0:
        np.savez(os.path.join(workdir, "slab_depth.npz"), **depth)
    return {"rank": rank, "warmup_ms": warm_ms, "request_ms": times, "launches": launches,
            "peak_mem_gib": peak_gib, "collectives": collectives, "kernel_depths": seen,
            "local_depths": local, "handoffs": handoffs, "variance_request_ms": var_ms,
            "variance_launches": var_launches, "variance_kernel_depths": vseen}


def local_depth_rule(world):
    """Each stage's CostRegNet level depths as one rank of ``world`` holds
    them: D/S where the level divides, the whole D where it runs whole."""
    from damvsnet_tpu_torch.parallel.slab import level_depths, slabbed
    return [[d // world if slabbed(d, world) else d for d in level_depths(n)] for n in NDEPTHS]


def check_slab_ranks(path, ranks, world, depths_key="kernel_depths", counters=(
        "fused_adaptive_cost_volume", "prob_volume_stats_fused")):
    """Every rank's kernel calls on D/S hypotheses (K2 on the whole D),
    each CostRegNet level's local D by the rule, and (where recorded) the
    stage handoffs bitwise equal across the ranks."""
    for r in ranks:
        for name in counters:
            calls = r[depths_key].get(name, [])
            want = [d if name == "prob_volume_stats_fused" else d // world for d in NDEPTHS]
            check(calls and all(calls[i:i + 3] == want for i in range(0, len(calls), 3)),
                  f"{path} rank {r['rank']}: {name} ran on depths {calls}, expected {want} "
                  "a request")
        if "local_depths" in r:
            check(r["local_depths"] == local_depth_rule(world),
                  f"{path} rank {r['rank']}: CostRegNet levels held {r['local_depths']}, "
                  f"the rule gives {local_depth_rule(world)}")
    if "handoffs" in ranks[0]:
        check(all(r["handoffs"] == ranks[0]["handoffs"] for r in ranks),
              f"{path}: the stage handoffs differ across the ranks")


def phase_slab_serving(sample, dev, smi, workdir, depth_tol):
    """Phase 21: phase 5's request with the depth hypotheses cut over 2
    ranks, against the one-process forward (bf16 at phase 5's limit, fp32
    at SLAB_FP32_TOL, which the planted fault must exceed); one variance
    request likewise in bf16. Returns ({path: {counter: launches}} summed
    over the ranks, the summary)."""
    import numpy as np
    import torch
    from damvsnet_tpu_torch.infer import DepthRunner
    from damvsnet_tpu_torch.model import CascadeMVSNet
    from damvsnet_tpu_torch.utils.weights import load_bench_weights
    batch = serving_batch(sample)
    want = {}
    for agg_mode in ("adaptive", "variance"):
        model = CascadeMVSNet(ndepths=NDEPTHS, compute_dtype=torch.bfloat16, device=dev,
                              agg_mode=agg_mode)
        load_bench_weights(model, SERVING_WEIGHTS)
        runner = DepthRunner(model, device=dev)
        want[f"{agg_mode}_bf16"] = runner(batch)["depth"]
        if agg_mode == "adaptive":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            model.compute_dtype = torch.float32
            want["adaptive_fp32"] = runner(batch)["depth"]
        del runner, model
        torch.cuda.empty_cache()
    ranks = spawn_ranks("slab_serve", workdir)
    for r in ranks:
        check_launches(f"slab serving rank {r['rank']}", r["launches"],
                       {"fused_adaptive_cost_volume": 3, "prob_volume_stats_fused": 3}, REQUESTS)
        check_launches(f"slab variance serving rank {r['rank']}", r["variance_launches"],
                       {"plane_sweep_variance": 3, "prob_volume_stats_fused": 3}, 1)
    check_slab_ranks("slab serving", ranks, RANKS)
    check_slab_ranks("slab variance serving", ranks, RANKS, "variance_kernel_depths",
                     ("plane_sweep_variance", "prob_volume_stats_fused"))
    got = np.load(os.path.join(workdir, "slab_depth.npz"))
    parity = {}
    for tag, ref, tol in (("bf16", "adaptive_bf16", depth_tol),
                          ("fp32", "adaptive_fp32", SLAB_FP32_TOL),
                          ("fp32_fault", "adaptive_fp32", SLAB_FP32_TOL),
                          ("variance_bf16", "variance_bf16", depth_tol)):
        check(got[tag].shape == want[ref].shape, f"slab {tag} depth: shape {got[tag].shape}")
        check(tag == "fp32_fault" or bool(np.isfinite(got[tag]).all()),
              f"slab {tag} depth: non-finite values")
        diff = np.abs(got[tag] - want[ref])
        parity[tag] = {"p999_abs": float(np.quantile(diff, 0.999)),
                       "max_abs": float(diff.max()), "tol": tol}
    summary = {"ranks": [{k: r[k] for k in ("rank", "warmup_ms", "request_ms", "peak_mem_gib",
                                            "collectives", "launches", "kernel_depths",
                                            "local_depths", "variance_request_ms",
                                            "variance_launches")} for r in ranks],
               "handoffs_equal": True, "parity_vs_one_process": parity, "card": smi}
    print(f"slab serving ({RANKS} gloo ranks)", json.dumps(summary), flush=True)
    for tag in ("bf16", "fp32", "variance_bf16"):
        p = parity[tag]
        check(p["p999_abs"] <= p["tol"], f"slab serving {tag}: depth p999 {p['p999_abs']} > "
              f"{p['tol']}")
    fault = parity["fp32_fault"]
    check(not fault["p999_abs"] <= fault["tol"], f"the planted fault (halos zeroed) passes the "
          f"fp32 limit: depth p999 {fault['p999_abs']} <= {fault['tol']}")
    return ({"serving_slab": sum_launches(ranks),
             "serving_variance_slab": sum_launches(
                 [{"launches": r["variance_launches"]} for r in ranks])}, summary)


def child_slab_train(workdir, data=1, backend="gloo"):
    """Phase 22 (a) (``data`` 1: the space group is every rank) and (c)
    (``data`` 2: the 2x2 mesh, each data rank its rows), a rank: 1 warm
    and TRAIN_STEPS timed bf16 fused steps with the counters and the depth
    of each K1 call, the halo exchanges of a step counted, one more step
    profiled for its collectives, a digest of the parameters after the
    steps; then one fp32 step from the trained weights (rank 0 saves it)
    and, at ``data`` 1, the same step with the slab shares' space sum left
    out (the planted fault). backend None: NCCL, a card a rank."""
    import torch
    from damvsnet_tpu_torch.parallel import batch_rows, make_mesh, slab
    from damvsnet_tpu_torch.train import loop
    from damvsnet_tpu_torch.train.loop import make_train_step
    from damvsnet_tpu_torch.train.schedule import make_optimizer
    from damvsnet_tpu_torch.train.state import TrainState
    rank, world, dev = child_device(backend)
    mesh = make_mesh(data=data, space=world // data)
    rows = batch_rows(TRAIN_B, mesh.data_rank, mesh.data)
    model = slab_model(dev, torch.bfloat16, mesh, fused_train=True)
    optimizer, scheduler = make_optimizer(model.parameters(), 1e-3, "10,12,14:2",
                                          iters_per_epoch=1000)
    state = TrainState(model, optimizer, scheduler)
    step = make_train_step(device=dev, mesh=mesh)
    batches = [train_rows(i, rows) for i in range(TRAIN_STEPS + 1)]
    t0 = time.perf_counter()
    step(state, batches[0])
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    reset_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    with kernel_depths() as seen:
        for batch in batches[1:]:
            t0 = time.perf_counter()
            metrics = step(state, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            metrics.pop("_images")
            losses.append({k: float(v) for k, v in metrics.items()})
    launches = read_counters()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    params = digest(model.parameters())
    halos, sound = [], slab.exchange_halo
    slab.exchange_halo = lambda *a, **k: halos.append(1) or sound(*a, **k)
    try:
        collectives = collective_profile(lambda: step(state, batches[1]))
    finally:
        slab.exchange_halo = sound
    del state, step, optimizer, scheduler, model
    torch.cuda.empty_cache()
    result = fp32_step_result(slab_model(dev, torch.float32, mesh, fused_train=True),
                              batches[1], dev, mesh)
    saved = {"fp32": result}
    if data == 1:
        torch.cuda.empty_cache()
        sound_sum = loop.sum_slab_shares
        loop.sum_slab_shares = lambda model: None
        try:
            saved["fp32_fault"] = fp32_step_result(
                slab_model(dev, torch.float32, mesh, fused_train=True), batches[1], dev, mesh)
        finally:
            loop.sum_slab_shares = sound_sum
    if rank == 0:
        torch.save(saved, os.path.join(workdir, f"slab_train_{data}x{world // data}.pt"))
    return {"rank": rank, "world": world, "mesh": [mesh.data, mesh.space], "rows": rows,
            "warmup_ms": warm_ms, "step_ms": step_ms, "metrics": losses, "launches": launches,
            "kernel_depths": seen, "peak_mem_gib": peak_gib, "params_digest": params,
            "halo_exchanges_per_step": len(halos), "collectives": collectives}


def child_slab_nonfused(workdir):
    """Phase 22 (b), a rank: the non-fused step (the JAX CLI's default) with
    the hypotheses cut over the ranks: 1 warm and 1 timed bf16 step, the
    counters (every kernel 0) and the peak memory; one more step
    profiled (``step_device_profile``)."""
    import torch
    from damvsnet_tpu_torch.parallel import make_mesh
    from damvsnet_tpu_torch.train.loop import make_train_step
    from damvsnet_tpu_torch.train.schedule import make_optimizer
    from damvsnet_tpu_torch.train.state import TrainState
    rank, world, dev = child_device()
    mesh = make_mesh(data=1, space=world)
    model = slab_model(dev, torch.bfloat16, mesh, fused_train=False, clamp_samples=False)
    optimizer, scheduler = make_optimizer(model.parameters(), 1e-3, "10,12,14:2",
                                          iters_per_epoch=1000)
    state = TrainState(model, optimizer, scheduler)
    step = make_train_step(device=dev, mesh=mesh)
    t0 = time.perf_counter()
    step(state, train_rows(0, range(TRAIN_B)))
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    reset_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with level_depths_held(model) as local:
        metrics = step(state, train_rows(1, range(TRAIN_B)))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    metrics.pop("_images")
    launches = read_counters()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    params = digest(model.parameters())
    return {"rank": rank, "warmup_ms": warm_ms, "step_ms": step_ms,
            "metrics": {k: float(v) for k, v in metrics.items()}, "launches": launches,
            "local_depths": local,
            "peak_mem_gib": peak_gib, "params_digest": params,
            "profile": step_device_profile(lambda: step(state, train_rows(2, range(TRAIN_B))))}


def step_device_profile(fn):
    """One call of ``fn`` under torch.profiler: its host time, the device
    time of its kernels, copies and fills (summed, overlap not removed; the
    device-side copies of the port's spans are annotations, left out),
    the eight kernels with the most device time, and the collectives' host
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if (e.device_type == DeviceType.CUDA and not e.is_user_annotation
                and not e.name.startswith("Activity Buffer")):
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    gloo = {e.key: {"count": e.count, "cpu_ms": e.cpu_time_total / 1e3}
            for e in prof.key_averages() if e.key.startswith(("gloo:", "nccl:"))}
    return {"profiled_wall_ms": wall, "device_ms": sum(by_name.values()),
            "top_kernels_ms": [[n[:90], ms] for n, ms in top], "collectives": gloo}


def check_slab_step(path, got, want):
    """A slab step's fp32 (metrics, gradients, statistics) against the
    one-process step's: loss at STEP_LOSS_RTOL, gradient relative L2 at
    STEP_GRAD_L2, running statistics at DDP_STATS_RTOL of each tensor's
    max. Returns the gaps."""
    (m, g, s), (mw, gw, sw) = got, want
    stats_rel = max(float((s[k] - v).abs().max()) / max(float(v.abs().max()), 1e-30)
                    for k, v in sw.items())
    gaps = {"loss_slab": m["loss"], "loss_one_process": mw["loss"],
            "grad_rel_l2": grad_rel_l2(g, gw), "running_stats_max_rel": stats_rel}
    check(abs(m["loss"] - mw["loss"]) <= STEP_LOSS_RTOL * abs(mw["loss"]),
          f"{path}: fp32 loss {m['loss']} vs one process {mw['loss']}")
    check(gaps["grad_rel_l2"] <= STEP_GRAD_L2,
          f"{path}: fp32 gradient relative L2 {gaps['grad_rel_l2']} > {STEP_GRAD_L2}")
    check(stats_rel <= DDP_STATS_RTOL, f"{path}: running statistics off by {stats_rel}")
    return gaps


def phase_slab_train(dev, smi, workdir, data_ranks=(1, 2), nonfused_peak=None,
                     backend="gloo"):
    """Phase 22: (a) phase 7's fused step with the hypotheses cut over 2
    ranks, (b) the non-fused step likewise (its peak per rank beside one
    process's), (c) the fused step on the 2x2 mesh (4 ranks, 2 rows a data
    rank); (a) and (c) in fp32 against the one-process step at B=4, the
    planted fault (no space sum) beside (a). ``data_ranks``: which of (a)
    (1, with (b)) and (c) (2) run; ``nonfused_peak``: phase 10's peak in
    one process, printed beside (b)'s (None: not measured in this run);
    ``backend`` "nccl": the ranks a card each (scripts/slab_cards_torch.py).
    Returns ({path: {counter: launches}} summed over
    the ranks, the summary)."""
    import torch
    global_batch = train_batch(range(TRAIN_B, 2 * TRAIN_B))
    want = fp32_step_result(ddp_model(dev, torch.float32), global_batch, dev, None)
    torch.cuda.empty_cache()
    launches, summary = {}, {"card": smi}
    for data in data_ranks:
        world = 2 * data
        path = f"training_slab_{data}x2"
        child = {1: "slab_train", 2: "slab_train_2x2"}[data] + ("" if backend == "gloo"
                                                                 else "_nccl")
        ranks = spawn_ranks(child, workdir, world)
        for r in ranks:
            check_launches(f"{path} rank {r['rank']}", r["launches"],
                           {"fused_adaptive_cost_volume": 3,
                            "fused_adaptive_cost_volume_backward": 3}, TRAIN_STEPS)
            for m in r["metrics"]:
                check(all(math.isfinite(v) for v in m.values()), f"{path} metrics {m}")
        check_slab_ranks(path, ranks, 2, counters=("fused_adaptive_cost_volume",))
        check(all(r["metrics"] == ranks[0]["metrics"] for r in ranks),
              f"{path}: the ranks' metrics differ")
        check(all(r["params_digest"] == ranks[0]["params_digest"] for r in ranks),
              f"{path}: the ranks' parameters drifted apart")
        saved = torch.load(os.path.join(workdir, f"slab_train_{data}x2.pt"))
        parity = {"fp32": check_slab_step(path, saved["fp32"], want)}
        if "fp32_fault" in saved:
            fault_l2 = grad_rel_l2(saved["fp32_fault"][1], want[1])
            parity["fp32_fault_grad_rel_l2"] = fault_l2
            check(fault_l2 > STEP_GRAD_L2, f"the planted fault (no space sum) passes: gradient "
                  f"relative L2 {fault_l2} <= {STEP_GRAD_L2}")
        summary[path] = {"ranks": [{k: r[k] for k in ("rank", "rows", "warmup_ms", "step_ms",
                                                      "peak_mem_gib", "halo_exchanges_per_step",
                                                      "collectives", "launches")}
                                   for r in ranks], "parity_vs_one_process": parity}
        launches[path] = sum_launches(ranks)
        print(f"slab training {data}x2 ({world} ranks)", json.dumps(summary[path]), flush=True)
        if data == 1:
            nonfused = spawn_ranks("slab_nonfused", workdir)
            for r in nonfused:
                check_launches(f"training_nonfused_slab rank {r['rank']}", r["launches"], {}, 1)
                check(all(math.isfinite(v) for v in r["metrics"].values()),
                      f"non-fused slab step metrics {r['metrics']}")
                check(r["local_depths"] == local_depth_rule(2),
                      f"non-fused slab rank {r['rank']}: levels {r['local_depths']}")
            check(all(r["params_digest"] == nonfused[0]["params_digest"] for r in nonfused),
                  "the non-fused slab ranks' parameters drifted apart")
            summary["training_nonfused_slab"] = {
                "ranks": [{k: r[k] for k in ("rank", "warmup_ms", "step_ms", "peak_mem_gib",
                                             "metrics", "profile")} for r in nonfused],
                "one_process_peak_gib": nonfused_peak}
            launches["training_nonfused_slab"] = sum_launches(nonfused)
            print("slab training non-fused (2 ranks)",
                  json.dumps(summary["training_nonfused_slab"]), flush=True)
        torch.cuda.empty_cache()
    return launches, summary


def phase_slab_cli(smi, workdir):
    """Phase 23: the training CLI on the 2x2 mesh (--mesh_data 2
    --mesh_space 2, 4 ranks) at phase 18's 128x160, then a 1-rank
    --resume from its checkpoint."""
    runs = spawn_ranks("slab_cli", workdir, world=4)
    logdir = os.path.join(workdir, "slab_run")
    ckpts = sorted(f for f in os.listdir(logdir) if f.startswith("ckpt_"))
    steps = CLI_TRAIN_SAMPLES // TRAIN_B
    check(ckpts == ["ckpt_000001.pt"], f"checkpoints after the 2x2 epoch: {ckpts}")
    check([r["step"] for r in runs] == [steps] * 4, f"steps {[r['step'] for r in runs]}")
    resumed = spawn_ranks("slab_cli", workdir, world=1, distributed=False)[0]
    check("resumed from" in resumed["log"] and "ckpt_000001.pt" in resumed["log"],
          "the 1-rank run did not resume from the 2x2 checkpoint")
    check((resumed["step"], resumed["epoch"]) == (2 * steps, 2),
          f"1-rank resume ended at step {resumed['step']}, epoch {resumed['epoch']}")
    summary = {"checkpoints": ckpts, "steps": [r["step"] for r in runs],
               "resumed": {"step": resumed["step"], "epoch": resumed["epoch"]}, "card": smi}
    print("training CLI on the 2x2 mesh (4 gloo ranks, then 1-rank resume)",
          json.dumps(summary), flush=True)
    return summary


RANK_CHILDREN = {"ddp_train": child_ddp_train,
                 "ddp_train_nccl": lambda workdir: child_ddp_train(workdir, backend=None),
                 "nccl_step": child_nccl_step,
                 "train_cli": child_train_cli, "test_cli": child_test_cli,
                 "fmt_sp": child_fmt_sp, "slab_serve": child_slab_serve,
                 "slab_train": child_slab_train,
                 "slab_train_2x2": lambda workdir: child_slab_train(workdir, data=2),
                 "slab_train_2x2_nccl": lambda workdir: child_slab_train(workdir, data=2,
                                                                         backend=None),
                 "slab_nonfused": child_slab_nonfused, "slab_cli": child_slab_cli}


def rank_child(phase, workdir):
    result = RANK_CHILDREN[phase](workdir)
    print("RESULT " + json.dumps(result), flush=True)
    return 0


def sum_launches(results):
    out = {}
    for r in results:
        for k, v in r["launches"].items():
            out[k] = out.get(k, 0) + v
    return out


def grad_rel_l2(got, want):
    """||got - want|| / ||want|| over every tensor of two {name: gradient}."""
    num = sum(float(((got[k] - g) ** 2).sum()) for k, g in want.items())
    den = sum(float((g ** 2).sum()) for g in want.values())
    return math.sqrt(num / max(den, 1e-30))


def phase_ddp_train(dev, smi, workdir, world=RANKS, backend="gloo"):
    """Phase 17: ``world`` ranks of ``backend`` (gloo: all on this card,
    then one NCCL step at world size 1; nccl: a card a rank). Returns
    ({counter: launches} summed over the ranks, the summary)."""
    import torch
    torch.cuda.empty_cache()
    ranks = spawn_ranks("ddp_train" if backend == "gloo" else "ddp_train_nccl", workdir, world)
    for r in ranks:
        check_launches(f"DDP training rank {r['rank']}", r["launches"],
                       {"fused_adaptive_cost_volume": 3,
                        "fused_adaptive_cost_volume_backward": 3}, TRAIN_STEPS)
        for m in r["metrics"]:
            check(all(math.isfinite(v) for v in m.values()), f"DDP step metrics {m}")
    check(all(r["metrics"] == ranks[0]["metrics"] for r in ranks),
          "the ranks' averaged metrics differ")
    # the same fp32 step in one process on the whole global batch, on the
    # kernels and on their plain versions: the ranks' K1 and K3 launches, at
    # their rows a rank, are held against the plain route directly
    got = torch.load(os.path.join(workdir, "ddp_fp32.pt"))
    global_batch = train_batch(range(TRAIN_B, 2 * TRAIN_B))
    metrics, grads, stats = fp32_step_result(ddp_model(dev, torch.float32), global_batch,
                                             dev, None)
    torch.cuda.empty_cache()
    plain_model = ddp_model(dev, torch.float32)
    plain_model.plain = True
    plain_metrics, plain_grads, _ = fp32_step_result(plain_model, global_batch, dev, None)
    del plain_model
    torch.cuda.empty_cache()
    stats_rel = max(float((got["stats"][k] - v).abs().max()) / max(float(v.abs().max()), 1e-30)
                    for k, v in stats.items())
    parity = {"loss_ranks": got["metrics"]["loss"], "loss_one_process": metrics["loss"],
              "grad_rel_l2": grad_rel_l2(got["grads"], grads),
              "loss_one_process_plain": plain_metrics["loss"],
              "grad_rel_l2_vs_plain": grad_rel_l2(got["grads"], plain_grads),
              "running_stats_max_rel": stats_rel,
              "tol": {"loss_rtol": STEP_LOSS_RTOL, "grad_rel_l2": STEP_GRAD_L2,
                      "running_stats_rel": DDP_STATS_RTOL}}
    nccl = None
    if backend == "gloo":
        nccl = spawn_ranks("nccl_step", workdir, world=1)[0]
        check(nccl["backend"] == "nccl", f"the default backend on the card is {nccl['backend']}")
        check_launches("NCCL world-1 step", nccl["launches"],
                       {"fused_adaptive_cost_volume": 3,
                        "fused_adaptive_cost_volume_backward": 3}, 1)
        check(math.isfinite(nccl["loss"]), f"NCCL step loss {nccl['loss']}")
    launches = sum_launches(ranks)
    summary = {"ranks": [{k: r[k] for k in ("rank", "rows", "warmup_ms", "step_ms",
                                            "peak_mem_gib", "collectives", "launches")}
                         for r in ranks],
               "fp32_vs_one_process": parity, "nccl_world1": nccl, "card": smi}
    print(f"training DDP ({world} {backend} ranks)", json.dumps(summary), flush=True)
    check(abs(parity["loss_ranks"] - parity["loss_one_process"])
          <= STEP_LOSS_RTOL * abs(parity["loss_one_process"]),
          f"DDP fp32 loss {parity['loss_ranks']} vs one process {parity['loss_one_process']}")
    check(parity["grad_rel_l2"] <= STEP_GRAD_L2,
          f"DDP fp32 gradient relative L2 {parity['grad_rel_l2']} > {STEP_GRAD_L2}")
    check(abs(parity["loss_ranks"] - parity["loss_one_process_plain"])
          <= STEP_LOSS_RTOL * abs(parity["loss_one_process_plain"]),
          f"DDP fp32 loss {parity['loss_ranks']} vs the plain route in one process "
          f"{parity['loss_one_process_plain']}")
    check(parity["grad_rel_l2_vs_plain"] <= STEP_GRAD_L2,
          f"DDP fp32 gradient relative L2 against the plain route "
          f"{parity['grad_rel_l2_vs_plain']} > {STEP_GRAD_L2}")
    check(stats_rel <= DDP_STATS_RTOL, f"DDP running statistics off by {stats_rel}")
    return launches, summary


def varint(b, i):
    """(value, next offset) of the protobuf varint at b[i]."""
    v = shift = 0
    while True:
        v |= (b[i] & 0x7F) << shift
        i += 1
        if not b[i - 1] & 0x80:
            return v, i
        shift += 7


def read_event_tags(path):
    """Every record of a TensorBoard event file, its length and data CRCs
    checked (the TFRecord framing the JAX package writes), and the tag of
    each Event's summary value (wall_time 1, step 2, summary 5 { value 1 {
    tag 1 } })."""
    import struct
    from damvsnet_tpu_torch.train.logging import _masked_crc32c
    blob = open(path, "rb").read()
    tags, i = [], 0
    while i < len(blob):
        header = blob[i:i + 8]
        (n,) = struct.unpack("<Q", header)
        check(struct.unpack("<I", blob[i + 8:i + 12])[0] == _masked_crc32c(header),
              f"{path}: a record's length CRC")
        event = blob[i + 12:i + 12 + n]
        check(struct.unpack("<I", blob[i + 12 + n:i + 16 + n])[0] == _masked_crc32c(event),
              f"{path}: a record's data CRC")
        check(event[0] == 0x09 and event[9] == 0x10, f"{path}: an event's wall_time, step")
        _, j = varint(event, 10)
        check(event[j] == 0x2A, f"{path}: an event without a summary")
        _, j = varint(event, j + 1)  # the summary's length
        check(event[j] == 0x0A, f"{path}: a summary without a value")
        _, j = varint(event, j + 1)  # the value's length
        check(event[j] == 0x0A, f"{path}: a value without a tag")
        tn, j = varint(event, j + 1)
        tags.append(event[j:j + tn].decode())
        i += 16 + n
    return tags


def phase_train_cli(smi, workdir):
    """Phase 18: the training CLI on 2 ranks with --profile_dir, then a
    1-rank --resume."""
    runs = spawn_ranks("train_cli", workdir)
    logdir = os.path.join(workdir, "train_run")
    ckpts = sorted(f for f in os.listdir(logdir) if f.startswith("ckpt_"))
    events = [f for f in os.listdir(logdir) if f.startswith("events.out.tfevents")]
    traces = sorted(os.listdir(os.path.join(workdir, "train_prof")))
    check(ckpts == ["ckpt_000001.pt"], f"checkpoints after the 2-rank epoch: {ckpts}")
    check(len(events) == 1, f"event files (rank 0 alone writes): {events}")
    check(traces == ["trace_rank0.json", "trace_rank1.json"], f"profiler traces: {traces}")
    kernels_traced = []
    for t in traces:
        with open(os.path.join(workdir, "train_prof", t)) as f:
            trace = json.load(f)
        kernels_traced.append(sum(e.get("cat") == "kernel" for e in trace["traceEvents"]))
    check(all(kernels_traced), f"device kernels in the ranks' traces: {kernels_traced}")
    tags = read_event_tags(os.path.join(logdir, events[0]))
    steps = 6 + CLI_TRAIN_SAMPLES // TRAIN_B
    check(tags.count("train/loss") == CLI_TRAIN_SAMPLES // TRAIN_B,
          f"train/loss events: {tags.count('train/loss')}")
    check([r["step"] for r in runs] == [steps] * RANKS, f"steps {[r['step'] for r in runs]}")
    resumed = spawn_ranks("train_cli", workdir, world=1, distributed=False)[0]
    check("resumed from" in resumed["log"] and "ckpt_000001.pt" in resumed["log"],
          "the 1-rank run did not resume from the 2-rank checkpoint")
    check((resumed["step"], resumed["epoch"]) == (steps + CLI_TRAIN_SAMPLES // TRAIN_B, 2),
          f"1-rank resume ended at step {resumed['step']}, epoch {resumed['epoch']}")
    summary = {"checkpoints": ckpts, "event_tags": sorted(set(tags)),
               "image_events": sum(t.startswith("train/") and t[6:] in IMAGE_KEYS for t in tags),
               "trace_kernel_events": kernels_traced, "steps": steps,
               "resumed": {"step": resumed["step"], "epoch": resumed["epoch"]}, "card": smi}
    print("training CLI (2 gloo ranks, then 1-rank resume)", json.dumps(summary), flush=True)
    return summary


def phase_scan_parallel(dev, smi, workdir, tol):
    """Phase 19: the test CLI over 2 scenes on 2 ranks against one process
    over the same scenes, the depth held to ``tol`` where it is not bitwise
    equal. Returns ({counter: launches} summed, summary)."""
    import numpy as np
    from damvsnet_tpu_torch.core.pfm import read_pfm
    from damvsnet_tpu_torch.data.synthetic import export_synthetic_scene
    datapath = os.path.join(workdir, "scan_data")
    with numpy_image_codec():
        for i, scan in enumerate(SCAN_SCENES):
            export_synthetic_scene(datapath, scan=scan, height=HEIGHT, width=WIDTH,
                                   nviews=EVAL_VIEWS, seed=SEED + i, num_depth=D0)
    with open(os.path.join(workdir, "scan_list.txt"), "w") as f:
        f.write("".join(f"{s}\n" for s in SCAN_SCENES))
    ranks = spawn_ranks("test_cli", workdir)
    owned = [r["scenes"] for r in ranks]
    check(sorted(s for o in owned for s in o) == SCAN_SCENES and not set(owned[0]) & set(owned[1]),
          f"scene ownership {owned}")
    for r in ranks:
        check_launches(f"scan-parallel CLI rank {r['rank']}", r["launches"],
                       {"fused_adaptive_cost_volume": 3, "prob_volume_stats_fused": 3,
                        "prob_conv3d": 3},
                       EVAL_VIEWS * len(r["scenes"]))
    with numpy_image_codec(), contextlib.redirect_stdout(io.StringIO()):
        cli_test_main(scan_cli_argv(datapath, os.path.join(workdir, "scan_list.txt"),
                                    os.path.join(workdir, "scan_sp")))
    bitwise, worst = True, 0.0
    for scan in SCAN_SCENES:
        for sub in ("depth_est", "confidence"):
            for name in sorted(os.listdir(os.path.join(workdir, "scan_sp", scan, sub))):
                a = read_pfm(os.path.join(workdir, "scan_mp", scan, sub, name))[0]
                b = read_pfm(os.path.join(workdir, "scan_sp", scan, sub, name))[0]
                bitwise &= bool(np.array_equal(a, b))
                if sub == "depth_est" and "_stage" not in name:
                    worst = max(worst, float(np.quantile(np.abs(a - b), 0.999)))
    summary = {"ownership": owned, "bitwise_equal": bitwise, "depth_p999_vs_one_process": worst,
               "tol": tol,
               "ranks": [{k: r[k] for k in ("rank", "cli_s", "s_per_view_steady",
                                            "peak_mem_gib", "launches")} for r in ranks],
               "card": smi}
    print("test CLI scan-parallel (2 gloo ranks)", json.dumps(summary), flush=True)
    check(bitwise or worst <= tol,
          f"scan-parallel depth p999 {worst} against one process")
    return sum_launches(ranks), summary


def phase_fmt_sp(sample, dev, smi, workdir, fmt_tol):
    """Phase 20: phase 14's FMT request with the attention sequence-parallel
    over 2 ranks, against the one-process forward (bf16 at phase 14's
    limit, fp32 at FMT_SP_FP32_TOL, which the planted fault must exceed).
    Returns ({counter: launches} summed, summary)."""
    import numpy as np
    import torch
    from damvsnet_tpu_torch.infer import DepthRunner
    model = seeded_model(dev, ("FMT_with_pathway",), use_fmt=True)
    runner = DepthRunner(model, device=dev)
    batch = serving_batch(sample)
    want = {"bf16": runner(batch)["depth"]}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model.compute_dtype = torch.float32
    want["fp32"] = runner(batch)["depth"]
    del runner, model
    torch.cuda.empty_cache()
    ranks = spawn_ranks("fmt_sp", workdir)
    for r in ranks:
        check_launches(f"FMT sequence-parallel rank {r['rank']}", r["launches"],
                       {"fused_adaptive_cost_volume": 3, "prob_volume_stats_fused": 3,
                        "prob_conv3d": 3},
                       REQUESTS)
    got = np.load(os.path.join(workdir, "fmt_sp_depth.npz"))
    parity = {}
    for tag, ref, tol in (("bf16", "bf16", fmt_tol), ("fp32", "fp32", FMT_SP_FP32_TOL),
                          ("fp32_fault", "fp32", FMT_SP_FP32_TOL)):
        check(got[tag].shape == want[ref].shape, f"FMT sequence-parallel {tag} depth: "
              f"shape {got[tag].shape}")
        check(tag == "fp32_fault" or bool(np.isfinite(got[tag]).all()),
              f"FMT sequence-parallel {tag} depth: non-finite values")
        diff = np.abs(got[tag] - want[ref])
        parity[tag] = {"p999_abs": float(np.quantile(diff, 0.999)),
                       "max_abs": float(diff.max()), "tol": tol}
    summary = {"ranks": [{k: r[k] for k in ("rank", "tokens_per_rank", "warmup_ms",
                                            "request_ms", "peak_mem_gib", "collectives",
                                            "launches")} for r in ranks],
               "parity_vs_one_process": parity, "card": smi}
    print("FMT serving, sequence-parallel (2 gloo ranks)", json.dumps(summary), flush=True)
    for tag in ("bf16", "fp32"):
        p = parity[tag]
        check(p["p999_abs"] <= p["tol"], f"FMT sequence-parallel {tag}: depth p999 "
              f"{p['p999_abs']} > {p['tol']}")
    fault = parity["fp32_fault"]
    check(not fault["p999_abs"] <= fault["tol"], f"the planted fault (no all-reduce) passes the "
          f"fp32 limit: depth p999 {fault['p999_abs']} <= {fault['tol']}")
    return sum_launches(ranks), summary


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--rank-child"]:
        return rank_child(*sys.argv[2:4])
    smi = nvidia_smi()
    print(f"card: {smi}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)
    dev = torch.device("cuda")

    from damvsnet_tpu_torch.data.synthetic import make_synthetic_sample
    from damvsnet_tpu_torch.model import CascadeMVSNet
    from damvsnet_tpu_torch.ops.kernels import build
    from damvsnet_tpu_torch.utils.weights import load_bench_weights

    t0 = time.perf_counter()
    logs = build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(logs) or 'nothing'}",
          flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    sample = make_synthetic_sample(height=HEIGHT, width=WIDTH, nviews=NVIEWS,
                                   ndepths=D0, with_gt=True, seed=SEED)
    model = CascadeMVSNet(ndepths=NDEPTHS, compute_dtype=torch.bfloat16, device=dev)
    load_bench_weights(model, SERVING_WEIGHTS)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        k1 = phase_k1(sample, model, dev)
        k2 = phase_k2(sample, dev)
        k5 = phase_prob_conv(model, dev)
    phase_k1_many_views(model, dev)
    torch.cuda.empty_cache()
    launches, request_ms = phase_cascade(sample, model, dev)
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad():
        k3 = phase_k3(model, dev)
    del model
    torch.cuda.empty_cache()
    train_launches, step_ms, train_peak = phase_train(dev)
    torch.cuda.empty_cache()

    model = CascadeMVSNet(ndepths=NDEPTHS, compute_dtype=torch.bfloat16, device=dev,
                          agg_mode="variance")
    load_bench_weights(model, SERVING_WEIGHTS)  # warns: the weight nets are dropped
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        k4 = phase_k4(sample, model, dev)
        k4_variance = phase_k4_variance(sample, model, dev)
        phase_k4_variance_many_views(model, dev)
    var_launches, var_request_ms = phase_variance(sample, model, dev)
    del model
    torch.cuda.empty_cache()
    nonfused_launches, nonfused_ms, nonfused_peak = phase_train_nonfused(
        dev, "training_nonfused", "adaptive", NONFUSED_STEPS)
    var_train_launches, var_train_ms, var_train_peak = phase_train_nonfused(
        dev, "training_variance", "variance", VARIANCE_STEPS)
    phase_nonfused_vs_cpu()
    torch.cuda.empty_cache()
    cli_launches, cli = phase_test_cli(dev)
    torch.cuda.empty_cache()
    fmt_launches, fmt_request_ms, fmt = phase_fmt_serving(sample, dev)
    torch.cuda.empty_cache()
    tv_launches, tv_step_ms, tv_peak = phase_train_variants(dev)
    vs_launches, vs_request_ms, vs_peak, _ = phase_variant_serving(sample, dev)
    torch.cuda.empty_cache()
    depth_tol = DEPTH_TOL_SHARE * float(sample["depth_values"][-1] - sample["depth_values"][0])
    with tempfile.TemporaryDirectory() as workdir:
        ddp_launches, ddp = phase_ddp_train(dev, smi, workdir)
        train_cli = phase_train_cli(smi, workdir)
        scan_launches, scan = phase_scan_parallel(dev, smi, workdir, depth_tol)
        sp_launches, sp = phase_fmt_sp(sample, dev, smi, workdir, fmt["parity"]["bf16"]["tol"])
        slab_launches, slab_serve = phase_slab_serving(sample, dev, smi, workdir, depth_tol)
        slab_train_launches, slab_train = phase_slab_train(dev, smi, workdir,
                                                           nonfused_peak=nonfused_peak)
        slab_launches.update(slab_train_launches)
        phase_slab_cli(smi, workdir)
    torch.cuda.empty_cache()
    tnt_launches, tnt = phase_tnt_recipe(dev)
    torch.cuda.empty_cache()
    chain_launches, chain = phase_accuracy_chain()

    def summary(name, rows, source, replaces, counter):
        """bf16 rows summed over the stages (one request's or one step's
        launches); library_ms where one PyTorch call computes the same."""
        main_rows = [r for r in rows if r["dtype"] == "bf16" and not r.get("align_corners")]
        by_path = {"serving": launches[counter], "training": train_launches[counter],
                   "serving_variance": var_launches[counter],
                   "training_nonfused": nonfused_launches[counter],
                   "training_variance": var_train_launches[counter],
                   "test_cli": cli_launches[counter],
                   "serving_fmt": fmt_launches[counter],
                   "training_variants": tv_launches[counter],
                   "serving_georeg_refine_unet": vs_launches[counter],
                   "training_ddp": ddp_launches[counter],
                   "test_cli_scan_parallel": scan_launches[counter],
                   "serving_fmt_sp": sp_launches[counter],
                   "test_cli_tnt_recipe": tnt_launches[counter],
                   "accuracy_chain": chain_launches[counter]}
        by_path.update({path: n[counter] for path, n in slab_launches.items()})
        library = [r.get("library_ms") for r in main_rows]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(by_path.values()), "launches_by_path": by_path,
                "max_abs_err": max(r["max_abs"] for r in main_rows),
                "ms": sum(r["ms"] for r in main_rows),
                "plain_ms": sum(r["plain_ms"] for r in main_rows),
                "kernel_ms": sum(r["kernel_ms"] for r in main_rows),
                "bound_ms": sum(r["bound_ms"] for r in main_rows),
                "bound_by": max(main_rows, key=lambda r: r["bound_ms"])["bound_by"],
                "library_ms": None if None in library else sum(library)}

    kernels = [
        summary("fused_adaptive_cost_volume", k1,
                "damvsnet_tpu_torch/ops/kernels/csrc/fused_costvol.cu",
                "damvsnet_tpu/ops/pallas/fused_costvol.py:471",
                "fused_adaptive_cost_volume"),
        summary("prob_volume_stats", k2,
                "damvsnet_tpu_torch/ops/kernels/csrc/probstats.cu",
                "damvsnet_tpu/ops/pallas/probstats.py:88",
                "prob_volume_stats_fused"),
        summary("fused_adaptive_cost_volume_backward", k3,
                "damvsnet_tpu_torch/ops/kernels/csrc/fused_costvol_bwd.cu",
                "damvsnet_tpu/ops/pallas/fused_costvol_vjp.py:373",
                "fused_adaptive_cost_volume_backward"),
        summary("plane_sweep_sample", k4,
                "damvsnet_tpu_torch/ops/kernels/csrc/sweep_sampler.cu",
                "damvsnet_tpu/ops/pallas/sweep_sampler.py:304",
                "plane_sweep_sample"),
        summary("plane_sweep_variance", k4_variance,
                "damvsnet_tpu_torch/ops/kernels/csrc/sweep_sampler.cu",
                "damvsnet_tpu/ops/pallas/sweep_sampler.py:304 + "
                "damvsnet_tpu/ops/costvol.py:63-77",
                "plane_sweep_variance"),
        summary("prob_conv3d", k5,
                "damvsnet_tpu_torch/ops/kernels/csrc/prob_conv.cu",
                "none: the JAX package leaves CostRegNet's prob conv to XLA",
                "prob_conv3d"),
    ]
    print(f"cascade: {request_ms:.3f} ms per request (bf16, {smi})", flush=True)
    print(f"training: {step_ms:.3f} ms per step, peak {train_peak:.2f} GiB "
          f"(512x640, B=4, N=5, bf16, {smi})", flush=True)
    print(f"variance cascade: {var_request_ms:.3f} ms per request (bf16, {smi})", flush=True)
    print(f"non-fused training: {nonfused_ms:.3f} ms per step, peak {nonfused_peak:.2f} GiB "
          f"(512x640, B=4, N=5, bf16, {smi})", flush=True)
    print(f"variance training: {var_train_ms:.3f} ms per step, peak {var_train_peak:.2f} GiB "
          f"(512x640, B=4, N=5, bf16, {smi})", flush=True)
    print(f"test CLI: {cli['s_per_view_steady']:.3f} s/view steady, write "
          f"{cli['write_s_total']} s for {EVAL_VIEWS} views, fusion "
          f"{cli['fusion_filter_ms_per_scene_card']:.1f} ms per scene on the card (votes "
          f"{cli['fusion_votes_ms_per_scene']['cuda']:.1f} ms card, "
          f"{cli['fusion_votes_ms_per_scene']['cpu']:.1f} ms CPU), peak "
          f"{cli['peak_mem_gib']:.2f} GiB, {cli['points']} points, acc "
          f"{cli['dtu_mm']['acc']:.4f} / comp {cli['dtu_mm']['comp']:.4f} / overall "
          f"{cli['dtu_mm']['overall']:.4f} mm (1152x864, N=5, bf16, {smi})", flush=True)
    print(f"FMT cascade: {fmt_request_ms:.3f} ms per request, peak {fmt['peak_mem_gib']:.2f} "
          f"GiB, FMT pathway {fmt['fmt_device_ms']:.3f} device ms in "
          f"{fmt['fmt_device_activities']:.0f} device activities of the request's "
          f"{fmt['request_device_ms']:.3f} (bf16, {smi})", flush=True)
    print(f"variant training (FMT, undetached): {tv_step_ms:.3f} ms per step, peak "
          f"{tv_peak:.2f} GiB (512x640, B=4, N=5, bf16, {smi})", flush=True)
    print(f"GeoReg/refine/U-Net cascade: {vs_request_ms:.3f} ms per request, peak "
          f"{vs_peak:.2f} GiB (bf16, {smi})", flush=True)
    for r in ddp["ranks"]:
        print(f"DDP training rank {r['rank']} (2 gloo ranks sharing the card, B=2 of 4 each): "
              f"{sum(r['step_ms']) / len(r['step_ms']):.3f} ms per step, peak "
              f"{r['peak_mem_gib']:.2f} GiB (512x640, N=5, bf16, {smi})", flush=True)
    print(f"training CLI on 2 ranks: {train_cli['steps']} steps, one checkpoint, "
          f"{len(train_cli['trace_kernel_events'])} traces, 1-rank resume to step "
          f"{train_cli['resumed']['step']} ({smi})", flush=True)
    for r in scan["ranks"]:
        print(f"scan-parallel test CLI rank {r['rank']}: {r['s_per_view_steady']} s/view "
              f"steady, {r['cli_s']:.1f} s for its scene (1152x864, N=5, bf16, {smi})",
              flush=True)
    for r in sp["ranks"]:
        print(f"FMT sequence-parallel rank {r['rank']} ({r['tokens_per_rank']} tokens): "
              f"{sum(r['request_ms']) / len(r['request_ms']):.3f} ms per request, peak "
              f"{r['peak_mem_gib']:.2f} GiB (bf16, {smi})", flush=True)
    for r in slab_serve["ranks"]:
        print(f"slab serving rank {r['rank']} (2 gloo ranks sharing the card, D/2 each): "
              f"{sum(r['request_ms']) / len(r['request_ms']):.3f} ms per request, peak "
              f"{r['peak_mem_gib']:.2f} GiB (bf16, {smi})", flush=True)
    for path in ("training_slab_1x2", "training_slab_2x2"):
        for r in slab_train[path]["ranks"]:
            print(f"{path} rank {r['rank']} (gloo ranks sharing the card): "
                  f"{sum(r['step_ms']) / len(r['step_ms']):.3f} ms per step, peak "
                  f"{r['peak_mem_gib']:.2f} GiB (512x640, N=5, bf16, {smi})", flush=True)
    for r in slab_train["training_nonfused_slab"]["ranks"]:
        print(f"non-fused slab training rank {r['rank']}: {r['step_ms']:.3f} ms for its step, "
              f"peak {r['peak_mem_gib']:.2f} GiB (one process: {nonfused_peak:.2f} GiB; "
              f"512x640, B=4, N=5, bf16, {smi})", flush=True)
    print(f"TnT recipe: {tnt['s_per_view_steady']:.3f} s/view steady, write "
          f"{tnt['write_s_total']} s for {TNT_VIEWS} views, votes "
          f"{tnt['fusion_votes_ms_per_scene']['cuda']:.1f} ms card, "
          f"{tnt['fusion_votes_ms_per_scene']['cpu']:.1f} ms CPU a scene (from "
          f"{TNT_CPU_REFS} references), peak "
          f"{tnt['peak_mem_gib']:.2f} GiB, {tnt['points']} points, launches "
          f"{json.dumps(tnt['launches'])} ({TNT_W}x{TNT_H}, {TNT_VIEWS} views, bf16, {smi})",
          flush=True)
    print(f"accuracy chain: {chain['train_steps']} training steps, "
          f"{chain['train_step_ms_median']:.1f} ms per step (median), epoch losses "
          f"{chain['epoch_loss']}, {chain['s_per_view']} s/view, depth "
          f"{chain['depth']['abs_err_mm_mean']} mm mean abs error, "
          f"{chain['depth']['frac_within_1_interval']} within one interval, "
          f"{chain['fusion']['points']} points, DTU acc {chain['dtu_mm']['acc']} / comp "
          f"{chain['dtu_mm']['comp']} / overall {chain['dtu_mm']['overall']} mm "
          f"({chain['dtu_mm']['backend']}), {chain['chain_s']:.1f} s "
          f"(128x160, N=5, fp32, 2 epochs, {smi})", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
