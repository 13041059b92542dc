"""damvsnet_tpu_torch: the PyTorch/CUDA port of damvsnet_tpu for NVIDIA Hopper.

The JAX package ``damvsnet_tpu`` is the reference; this package mirrors its
module layout so each counterpart is easy to find, and imports nothing of
it. The TPU's Pallas kernels on the serving path are hand-written CUDA C++
kernels here (``ops/kernels/csrc``), each beside a plain PyTorch version.

Layout:
  core/      per-stage camera matrices                   (numpy)
  data/      the procedural synthetic scene              (numpy)
  ops/       resize / warp / sampling / cost volume / stats (torch)
  ops/kernels/  CUDA kernels, their build and their wrappers
  nn/        nn.Modules (FPN, 3D U-Net, AggWeightNet, GeoFusion)
  model/     the inference cascade
  infer/     DepthRunner
  utils/     device selection, the flax-checkpoint weight bridge

Entry points (``model.CascadeMVSNet`` + ``utils.weights.load_bench_weights``,
``infer.DepthRunner``) run on CUDA unless the caller passes
``device="cpu"``; without a CUDA device they raise.
"""

__version__ = "0.1.0"
