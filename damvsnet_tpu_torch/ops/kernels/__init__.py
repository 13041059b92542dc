"""Hand-written CUDA kernels for Hopper, the counterpart of
damvsnet_tpu/ops/pallas/. Each wrapper launches its kernel on a CUDA tensor
and runs its plain PyTorch version on a CPU tensor; nothing falls back.

A kernel is one source ``csrc/<name>.cu`` (``build.py`` finds it) and one
wrapper that declares its entry point (``_common.Entry``) and counts its
launches (``@_common.counts``). ``COUNTED`` is every such wrapper, K1-K5
(K4's sampler and variance entries), in the order the launch records list
them."""
from .fused_costvol import fused_adaptive_cost_volume, fused_adaptive_cost_volume_backward
from .prob_conv import prob_conv3d
from .probstats import prob_volume_stats_fused
from .sweep_sampler import plane_sweep_sample, plane_sweep_variance

COUNTED = (fused_adaptive_cost_volume, prob_volume_stats_fused,
           fused_adaptive_cost_volume_backward, plane_sweep_sample, plane_sweep_variance,
           prob_conv3d)
