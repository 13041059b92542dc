"""The launch seam of the kernel wrappers (``Entry``, ``counts``) and the
argument checks and helpers they share."""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ..warp import geoms_from_projs, pixel_affine
from . import build

# what the plane-sweep kernels (csrc/sampling.cuh) take: feature dtypes,
# with the code each entry point reads, and channel counts (whole 16-byte
# vectors of 8 channels)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
SUPPORTED_CHANNELS = (8, 16, 32)
MAX_VIEWS = 16  # kMaxViews in csrc/common.cuh: source views of one launch
# the entries' argument types: a pointer, int, long long and float
VP, INT, LL, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


def view_chunks(v: int) -> list[slice]:
    """The source views of a call split into launches of at most MAX_VIEWS,
    as even as they come (17 views: 8 and 9)."""
    n = -(-v // MAX_VIEWS)
    bounds = [v * i // n for i in range(n + 1)]
    return [slice(a, b) for a, b in zip(bounds[:-1], bounds[1:])]


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
    """The kernels index inside one [H, W, C] plane with 32-bit offsets.
    No configuration of the CLIs comes near: the largest plane is
    Tanks-and-Temples' 1056 x 1920 x 8 at stage 3, 0.76 % of 2^31."""
    if h * w * c >= 2 ** 31:
        raise ValueError(f"{name}: an [H, W, C] = {(h, w, c)} plane holds 2^31 or "
                         "more elements; the kernels index a plane with 32 bits")


def check_launch(name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")


class Entry:
    """The C entry point ``symbol`` of csrc/<library>.cu, which takes
    ``argtypes`` and then the stream and returns a CUDA error code. The
    library is built and loaded, and the function's argument types set,
    once per process, at the first launch."""

    def __init__(self, library: str, symbol: str, *argtypes):
        self.library, self.symbol = library, symbol
        self.argtypes = [*argtypes, ctypes.c_void_p]
        self.wrapper = None  # set by ``counts``
        self._fn = None

    def bind(self):
        if self._fn is None:
            fn = getattr(build.load(self.library), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, dev: torch.device, *args) -> None:
        """Launch on ``dev``'s current stream, count the launch in the
        wrapper's ``.launches`` and raise on a CUDA error."""
        fn = self.bind()
        stream = torch.cuda.current_stream(dev).cuda_stream
        self.wrapper.launches += 1
        check_launch(self.wrapper.__name__, fn(*args, stream))


def counts(entry: Entry):
    """Decorator of a kernel wrapper: ``entry``'s launches are counted in
    the wrapper's ``.launches`` (from 0), and ``wrapper.entry`` is it."""
    def mark(wrapper):
        wrapper.launches, wrapper.entry, entry.wrapper = 0, entry, wrapper
        return wrapper
    return mark


def pointer_array(tensors):
    """The tensors' device pointers as a HOST array, as the multi-view
    entries take their source views."""
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


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


@dataclass
class ViewLaunch:
    """What the kernels over a reference and V source views (K1, K3 and
    both K4 entries, the sampler's one view standing in for the reference)
    share for one call: shapes, strides, the per-view geometry, the depth
    hypotheses and the grid affine."""
    name: str
    dev: torch.device
    b: int
    d: int
    h: int
    w: int
    c: int
    v: int
    ref_bstride: int
    src_bstride: int
    geom: torch.Tensor
    dv: torch.Tensor
    per_pixel: int
    affine: tuple


def prepare_views(name, ref_fea, src_feas, ref_proj, src_projs, depth_values,
                  align_corners: bool = False) -> ViewLaunch:
    """Check the inputs (raise on what the kernels do not take) and build
    every view's geometry at once, without a sync."""
    dev = check_cuda(name, ref_fea, *src_feas, ref_proj, *src_projs, depth_values)
    if ref_fea.dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: feature dtype {ref_fea.dtype} is not float32 "
                         "or bfloat16")
    b, h, w, c = ref_fea.shape
    v = len(src_feas)
    if c not in SUPPORTED_CHANNELS:
        raise ValueError(f"{name}: C={c} not in {SUPPORTED_CHANNELS}")
    check_plane(name, h, w, c)
    if not 1 <= v <= MAX_VIEWS:
        raise ValueError(f"{name}: {v} source views, supported 1..{MAX_VIEWS}")
    if len(src_projs) != v:
        raise ValueError(f"{name}: {v} source features but {len(src_projs)} "
                         "projections")
    plane = (w * c, c, 1)
    if tuple(ref_fea.stride()[1:]) != plane:
        raise ValueError(f"{name}: each feature [H, W, C] plane must be contiguous")
    src_bstride = src_feas[0].stride(0) if b > 1 else 0
    for s in src_feas:
        if s.dtype != ref_fea.dtype or tuple(s.shape) != (b, h, w, c):
            raise ValueError(f"{name}: source feature {tuple(s.shape)} "
                             f"{s.dtype} does not match the reference "
                             f"{(b, h, w, c)} {ref_fea.dtype}")
        if tuple(s.stride()[1:]) != plane or (b > 1 and s.stride(0) != src_bstride):
            raise ValueError(f"{name}: each source [H, W, C] plane must be "
                             "contiguous, with one batch stride for all views")
    if any(t.data_ptr() % 16 for t in (ref_fea, *src_feas)):
        raise ValueError(f"{name}: feature pointers must be 16-byte aligned")
    d = depth_values.shape[1]
    dv, per_pixel = depth_argument(depth_values.detach(), b, d, h, w)
    with torch.no_grad():
        geom = geoms_from_projs(src_projs, ref_proj).contiguous()
    return ViewLaunch(name, dev, b, d, h, w, c, v,
                      ref_fea.stride(0) if b > 1 else 0, src_bstride, geom, dv,
                      per_pixel, (*pixel_affine(w, align_corners),
                                  *pixel_affine(h, align_corners)))
