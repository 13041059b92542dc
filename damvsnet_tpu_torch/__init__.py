"""damvsnet_tpu_torch: the PyTorch/CUDA port of damvsnet_tpu for NVIDIA Hopper.

The JAX package ``damvsnet_tpu`` is the reference; this package mirrors its
module layout so each counterpart is easy to find, and imports nothing of
it. The TPU's Pallas kernels on the serving path are hand-written CUDA C++
kernels here (``ops/kernels/csrc``), each beside a plain PyTorch version.

Layout:
  core/      camera, pfm, pair, PLY and image-file IO     (numpy; the codecs
             behind core/imageio.py)
  data/      training and eval loaders, the synthetic scene (numpy)
  ops/       resize / warp / sampling / cost volume / stats (torch)
  ops/kernels/  CUDA kernels, their build and their wrappers
  nn/        nn.Modules (FPN, 3D U-Net, AggWeightNet, GeoFusion)
  model/     the cascade, serving and training
  losses/, train/  losses, the train step, loop and checkpoints
  infer/     DepthRunner, the depth-file writer, fusion (device-batched
             and host)
  eval/      the DTU protocol                            (numpy, scipy)
  cli/       train, test, eval_dtu, colmap2mvsnet
  native_ext.py  the optional host C++ pass of native/fusion.cpp
  utils/     device selection, the flax-checkpoint weight bridge

Entry points (``model.CascadeMVSNet`` + ``utils.weights.load_bench_weights``,
``infer.DepthRunner``, ``infer.fusion_device``, the CLIs) run on CUDA unless
the caller passes ``device="cpu"`` (``--device cpu``); without a CUDA
device they raise.
"""

__version__ = "0.1.0"
