"""The benchmark's fixed arithmetic: the H100's published peaks, the
kernels' least times (roofline bounds) from their shapes, the FLOPs of a
request or a step counted on the plain reference, and the naming of
device operations by family.

The bounds are ``chip_smoke.py``'s (``k1_bound_ms``, ``k2_bound_ms``,
``k4_variance_bound_ms``), copied so that the yardstick stays where a
change to the program cannot move it. The families are
``scripts/profile_torch_cascade.py``'s.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

# NVIDIA H100 SXM data sheet, dense, at 700 W
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
ELEM_BYTES = {"bfloat16": 2, "float32": 4}


def _bound(bytes_, ops):
    return max(bytes_ / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3


def k1_bound_ms(b, d, h, w, c, v, elem, per_pixel):
    """K1, the fused adaptive cost volume: the V+1 feature planes read
    once, the depths, the volume written once; per voxel and view ~30
    operations of geometry, 4 taps x C fma, the squared difference and the
    weight dot 4C, the weight net ~8, the sum 2C; then the 1/(N-1) scale."""
    bytes_ = ((v + 1) * b * h * w * c * elem + b * d * (h * w if per_pixel else 1) * 4
              + b * d * h * w * c * elem)
    return _bound(bytes_, b * d * h * w * (v * (14 * c + 60) + c))


def k2_bound_ms(b, d, h, w, per_pixel, cost_elem):
    """K2, the probability-volume statistics: the cost read once in its
    dtype, the depths, prob and the three maps written once in fp32."""
    n = b * h * w
    bytes_ = n * d * (cost_elem + 4) + (n * d if per_pixel else b * d) * 4 + 3 * n * 4
    return _bound(bytes_, n * d * 17 + n * 4)


def k4_variance_bound_ms(b, d, h, w, c, v, elem, per_pixel):
    """K4's variance entry: the V+1 feature planes read once, the depths,
    the volume written once; per voxel and view ~30 operations of
    projection and tap weights, 4 taps x C fma and the two sums 2C; then
    the mean and variance ~5C."""
    bytes_ = ((v + 1) * b * h * w * c * elem + b * d * (h * w if per_pixel else 1) * 4
              + b * d * h * w * c * elem)
    return _bound(bytes_, b * d * h * w * (v * (10 * c + 30) + 5 * c))


STAGE_CHANNELS = (32, 16, 8)


def serving_bounds_ms(model_cfg, traffic, compute_dtype):
    """{kernel: least ms a request} summed over the three stages' shapes:
    "k1" (adaptive) or "k4var" (variance), and "k2"."""
    elem = ELEM_BYTES[compute_dtype]
    b, v = traffic["batch"], traffic["nviews"] - 1
    out = {"k2": 0.0, "k1" if model_cfg["agg_mode"] == "adaptive" else "k4var": 0.0}
    for i, d in enumerate(model_cfg["ndepths"]):
        h, w, c = traffic["height"] >> (2 - i), traffic["width"] >> (2 - i), STAGE_CHANNELS[i]
        per_pixel = i > 0
        if "k1" in out:
            out["k1"] += k1_bound_ms(b, d, h, w, c, v, elem, per_pixel)
        else:
            out["k4var"] += k4_variance_bound_ms(b, d, h, w, c, v, elem, per_pixel)
        out["k2"] += k2_bound_ms(b, d, h, w, per_pixel, elem)
    return out


def counted_flops(cfg, traffic, kind):
    """The matmul and convolution FLOPs of one request (``kind`` "serve")
    or one step, forward and backward ("train"), counted by
    ``torch.utils.flop_counter`` on the reference module the configuration
    names, at the cell's shapes (the whole batch), on the meta device:
    shapes only, nothing computed."""
    from . import reference

    ref = reference.for_config(cfg)
    training = kind == "train"
    rcfg = ref.settings(cfg, kind)
    params, buffers = ref.load_weights(cfg["weights"], rcfg["model"])
    params = {k: torch.empty_like(t, device="meta").requires_grad_(training)
              for k, t in params.items()}
    buffers = {k: torch.empty_like(t, device="meta") for k, t in buffers.items()}
    b, n, h, w = traffic["batch"], traffic["nviews"], traffic["height"], traffic["width"]
    meta = lambda *s: torch.empty(*s, device="meta")  # noqa: E731
    batch = {"imgs": meta(b, n, h, w, 3), "depth_values": meta(b, traffic["numdepth"]),
             "proj_matrices": {f"stage{s}": meta(b, n, 2, 4, 4) for s in (1, 2, 3)},
             "depth": {f"stage{s}": meta(b, h >> (3 - s), w >> (3 - s)) for s in (1, 2, 3)}}
    batch["mask"] = batch["depth"]
    with FlopCounterMode(display=False) as counter:
        loss = ref.counted_pass(params, buffers, rcfg, batch, training)
        if training:
            torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return counter.get_total_flops()


# kernel-name substrings -> family, first match wins
FAMILIES = (
    ("K1 fused cost volume", ("fused_costvol_kernel",)),
    ("K3 fused cost volume backward", ("fused_costvol_bwd_kernel",)),
    ("K2 prob stats", ("probstats_kernel",)),
    ("K4 plane-sweep sampler", ("sweep_sampler_kernel",)),
    ("K4 variance cost volume", ("sweep_variance_kernel",)),
    # NCCL's kernels (ncclDevKernel_AllReduce..., _AllGather...) before
    # "gather / scatter" and "reduction" below
    ("collective (NCCL)", ("nccl",)),
    ("optimizer (Adam)", ("multi_tensor", "adam")),
    # cuDNN's BN kernels (bn_fw/bn_bw, batchnorm_*) before "cudnn" below
    ("batch norm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw", "welford")),
    ("convolution", ("conv", "xmma", "gemm", "cudnn", "cutlass", "dgrad", "wgrad",
                     "implicit", "winograd", "sm90", "fft")),
    ("resize", ("upsample", "interp")),
    ("layer norm", ("layer_norm",)),
    ("pooling", ("pool",)),
    ("gather / scatter", ("index", "scatter", "gather", "radix", "sort")),
    ("reduction", ("reduce", "softmax", "min_max")),
    ("copy / layout", ("copy", "memcpy", "memset", "cat", "fill")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def union_length(intervals):
    """Total length covered by [(start, end)] intervals, overlaps once."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total
