"""Resizes, the plane-sweep warp, the depth samplers, the probability-volume
statistics and the cost volumes, in plain PyTorch (counterpart of
damvsnet_tpu/ops); the CUDA kernels are in ``ops.kernels``."""
from .costvol import build_cost_volume
from .regression import depth_regression, prob_volume_stats
from .resize import resize_bilinear, resize_nearest, resize_trilinear_depth
from .sampling import uncertainty_aware_samples, uniform_depth_samples
from .warp import bilinear_sample_zeros, plane_sweep_warp
