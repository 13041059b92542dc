"""Argument checks and helpers shared by the kernel wrappers."""
from __future__ import annotations

import torch

# what the plane-sweep kernels (csrc/sampling.cuh) take: feature dtypes,
# with the code each entry point reads, and channel counts (whole 16-byte
# vectors of 8 channels)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
SUPPORTED_CHANNELS = (8, 16, 32)


def check_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """All tensors on one CUDA device; returns it. Raises otherwise."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors must lie on a CUDA device "
                         f"(or all on the CPU for the plain version), got {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices: "
                             f"{t.device} and {dev}")
    return dev


def check_plane(name: str, h: int, w: int, c: int) -> None:
    """The kernels index inside one [H, W, C] plane with 32-bit offsets."""
    if h * w * c >= 2 ** 31:
        raise ValueError(f"{name}: an [H, W, C] = {(h, w, c)} plane holds 2^31 or "
                         "more elements; the kernels index a plane with 32 bits")


def check_launch(name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")


def depth_argument(depth_values: torch.Tensor, b: int, d: int, h: int, w: int):
    """(contiguous fp32 tensor, per_pixel flag) for a [B, D] sweep or a
    [B, D, H, W] hypothesis volume. A [B, D, H, W] view expanded from
    [B, D] (stride 0 over H and W) is passed as [B, D] and never
    materialized."""
    if depth_values.dtype != torch.float32:
        raise ValueError(f"depth values must be float32, got {depth_values.dtype}")
    if depth_values.dim() == 4:
        if tuple(depth_values.shape) != (b, d, h, w):
            raise ValueError(f"depth values {tuple(depth_values.shape)} do not "
                             f"match [B, D, H, W] = {(b, d, h, w)}")
        if depth_values.stride(2) == 0 and depth_values.stride(3) == 0:
            return depth_values[:, :, 0, 0].contiguous(), 0
        return depth_values.contiguous(), 1
    if tuple(depth_values.shape) != (b, d):
        raise ValueError(f"depth values {tuple(depth_values.shape)} are "
                         f"neither [B, D] nor [B, D, H, W]")
    return depth_values.contiguous(), 0
