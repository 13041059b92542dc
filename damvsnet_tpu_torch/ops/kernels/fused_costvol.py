"""Fused adaptive cost volume and its backward: wrappers of
csrc/fused_costvol.cu (K1) and csrc/fused_costvol_bwd.cu (K3).

K1 replaces damvsnet_tpu/ops/pallas/fused_costvol.py::fused_adaptive_cost_volume.
Warp, squared difference, the folded AggWeightNet and the sum over views run
in one CUDA kernel; no per-view volume reaches device memory. The kernel
gathers every bilinear tap, so unlike the TPU kernel it has no window
budget and returns no overflow flag.

K3 replaces the backward of damvsnet_tpu/ops/pallas/fused_costvol_vjp.py
(the custom VJP of the training path): on a CUDA tensor that requires
grad, ``fused_adaptive_cost_volume`` is a ``torch.autograd.Function`` whose
forward launches K1 and whose backward launches K3. Gradients reach the
reference and source features and the folded weight net (w1, b1, w2, b2);
depth hypotheses and geometry get none, as under the reference's no_grad
sampling grid (module.py:297-300), and neither does the 1/(N-1) constant.

One launch takes at most 16 source views (``_common.MAX_VIEWS``). Past
that the wrapper splits the views into launches of at most 16, each a K1
call (under autograd, with K3 as its backward) over its V_k views, and sums
their volumes scaled by V_k / V in fp32, cast once.

Layout: features NHWC [B, H, W, C] (free views of ``channels_last``
feature maps), volume [B, D, H, W, C] contiguous — its
``permute(0, 4, 1, 2, 3)`` is a ``channels_last_3d`` view for Conv3d.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ..costvol import build_cost_volume
from ._common import DTYPE_CODES, MAX_VIEWS, ViewLaunch, check_launch, prepare_views, view_chunks
from .build import load


def folded_weight_fn(w1, b1, w2, b2):
    """The folded AggWeightNet w(x) = relu(w2 * relu(<x, w1> + b1) + b2)
    on a [..., C] fp32 squared difference -> [..., 1]."""
    def weight_fn(diff_sq):
        s = (diff_sq * w1.float()).sum(-1, keepdim=True)
        return torch.relu(w2 * torch.relu(s + b1) + b2)
    return weight_fn


def fused_adaptive_cost_volume_plain(ref_fea, src_feas, ref_proj, src_projs,
                                     depth_values, w1, b1, w2, b2, align_corners=False):
    """The kernel's plain PyTorch version (same inputs, same result).
    The plain warp detaches its sampling coordinates, so torch autograd
    through this function is the plain version of K3."""
    return build_cost_volume(ref_fea, src_feas, ref_proj, src_projs, depth_values,
                             folded_weight_fn(w1, b1, w2, b2), align_corners)


def fused_adaptive_cost_volume_backward_plain(grad_out, ref_fea, src_feas,
                                              ref_proj, src_projs, depth_values,
                                              w1, b1, w2, b2, align_corners=False):
    """K3's plain version: torch autograd of the plain forward with
    cotangent ``grad_out``. Returns (dref, [dsrc_v], dw1, db1, dw2, db2)."""
    with torch.enable_grad():
        feas = [t.detach().requires_grad_() for t in (ref_fea, *src_feas)]
        wts = [torch.as_tensor(t, dtype=torch.float32, device=ref_fea.device)
               .detach().requires_grad_() for t in (w1, b1, w2, b2)]
        vol = fused_adaptive_cost_volume_plain(feas[0], feas[1:], ref_proj,
                                               src_projs, depth_values, *wts,
                                               align_corners)
        grads = torch.autograd.grad(vol, feas + wts, grad_out)
    v = len(src_feas)
    return (grads[0], list(grads[1:1 + v]), *grads[1 + v:])


def _params(w1, b1, w2, b2, L: ViewLaunch) -> torch.Tensor:
    """[w1 (C), b1, w2, b2, 1/(N-1)] fp32, differentiable in w1..b2. Built
    on the device (a fill, never a host copy) so no launch syncs."""
    scal = [x.float().reshape(1) if torch.is_tensor(x)
            else torch.full((1,), float(x), device=L.dev)
            for x in (b1, w2, b2)]
    inv = torch.full((1,), 1.0 / L.v, device=L.dev)
    return torch.cat([w1.float().reshape(L.c), *scal, inv])


def _bind_forward(lib):
    fn = lib.fused_costvol_launch
    vp, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    fn.argtypes = [vp, ll, ctypes.POINTER(vp), ll, i, vp, vp, i, vp, vp,
                   i, i, i, i, i, i, f, f, f, f, vp]
    fn.restype = i
    return fn


def _bind_backward(lib):
    fn = lib.fused_costvol_bwd_launch
    vp, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    fn.argtypes = [vp, ll, ctypes.POINTER(vp), ll, i, vp, vp, i, vp, vp, vp, vp,
                   vp, vp, i, i, i, i, i, i, f, f, f, f, vp]
    fn.restype = i
    return fn


def _launch_forward(L: ViewLaunch, params, ref_fea, src_feas) -> torch.Tensor:
    out = torch.empty((L.b, L.d, L.h, L.w, L.c), dtype=ref_fea.dtype, device=L.dev)
    params = params.detach().contiguous()
    fn = _bind_forward(load("fused_costvol"))
    stream = torch.cuda.current_stream(L.dev).cuda_stream
    fused_adaptive_cost_volume.launches += 1
    err = fn(ref_fea.data_ptr(), L.ref_bstride,
             (ctypes.c_void_p * L.v)(*[s.data_ptr() for s in src_feas]),
             L.src_bstride, L.v, L.geom.data_ptr(), L.dv.data_ptr(), L.per_pixel,
             params.data_ptr(), out.data_ptr(), L.b, L.d, L.h, L.w, L.c,
             DTYPE_CODES[ref_fea.dtype], *L.affine, stream)
    check_launch(L.name, err)
    return out


def _launch_backward(L: ViewLaunch, params, ref_fea, src_feas, grad_out, atomics=None):
    """K3: (dref [B,H,W,C], [dsrc_v], dw [C+3] = dw1, db1, dw2, db2).
    ``atomics``, a one-element int64 CUDA tensor or None: the launch adds
    its count of 16-byte source-gradient atomics to it (a measurement;
    the main path passes None)."""
    if (grad_out.device != L.dev or grad_out.dtype != ref_fea.dtype
            or tuple(grad_out.shape) != (L.b, L.d, L.h, L.w, L.c)):
        raise ValueError(f"{L.name}: the cotangent {tuple(grad_out.shape)} "
                         f"{grad_out.dtype} on {grad_out.device} does not match "
                         f"the volume {(L.b, L.d, L.h, L.w, L.c)} "
                         f"{ref_fea.dtype} on {L.dev}")
    if not grad_out.is_contiguous():
        raise ValueError(f"{L.name}: the cotangent must be contiguous")
    dref = torch.empty((L.b, L.h, L.w, L.c), dtype=torch.float32, device=L.dev)
    dsrc = torch.zeros((L.v, L.b, L.h, L.w, L.c), dtype=torch.float32, device=L.dev)
    dw = torch.zeros(L.c + 3, dtype=torch.float32, device=L.dev)
    params = params.detach().contiguous()
    fn = _bind_backward(load("fused_costvol_bwd"))
    stream = torch.cuda.current_stream(L.dev).cuda_stream
    fused_adaptive_cost_volume_backward.launches += 1
    err = fn(ref_fea.data_ptr(), L.ref_bstride,
             (ctypes.c_void_p * L.v)(*[s.data_ptr() for s in src_feas]),
             L.src_bstride, L.v, L.geom.data_ptr(), L.dv.data_ptr(), L.per_pixel,
             params.data_ptr(), grad_out.data_ptr(), dref.data_ptr(),
             dsrc.data_ptr(), dw.data_ptr(),
             None if atomics is None else atomics.data_ptr(), L.b, L.d, L.h, L.w, L.c,
             DTYPE_CODES[ref_fea.dtype], *L.affine, stream)
    check_launch(L.name, err)
    dt = ref_fea.dtype
    return dref.to(dt), [g.to(dt) for g in dsrc.unbind(0)], dw


class _FusedCostVolume(torch.autograd.Function):
    """Forward K1, backward K3."""

    @staticmethod
    def forward(ctx, L, params, ref_fea, *src_feas):
        ctx.launch = L
        ctx.save_for_backward(params, ref_fea, *src_feas)
        return _launch_forward(L, params, ref_fea, src_feas)

    @staticmethod
    def backward(ctx, grad_out):
        params, ref_fea, *src_feas = ctx.saved_tensors
        dref, dsrc, dw = _launch_backward(ctx.launch, params, ref_fea, src_feas,
                                          grad_out.contiguous())
        dparams = torch.cat([dw, dw.new_zeros(1)])  # 1/(N-1): no gradient
        return (None, dparams, dref, *dsrc)


def fused_adaptive_cost_volume(ref_fea: torch.Tensor,
                               src_feas: Sequence[torch.Tensor],
                               ref_proj: torch.Tensor,
                               src_projs: Sequence[torch.Tensor],
                               depth_values: torch.Tensor,
                               w1, b1, w2, b2, align_corners: bool = False) -> torch.Tensor:
    """Adaptive cost volume [B, D, H, W, C] in the feature dtype.

    ref_fea [B,H,W,C]; src_feas: V tensors [B,H,W,C]; projs fused [B,4,4];
    depth_values [B,D] or [B,D,H,W] fp32; (w1 [C], b1, w2, b2) from
    ``nn.aggweight.fold_aggweight``; align_corners: the grid
    un-normalization (ops/warp.py), which the kernels read as the pixel
    affine (sx, ox, sy, oy). CPU tensors run the plain version
    (differentiable by torch autograd); CUDA tensors launch K1, with K3 as
    the backward when a feature or weight requires grad, or raise. More
    than 16 source views take one launch per chunk of at most 16."""
    if ref_fea.device.type == "cpu":
        return fused_adaptive_cost_volume_plain(
            ref_fea, src_feas, ref_proj, src_projs, depth_values, w1, b1, w2, b2,
            align_corners)
    v = len(src_feas)
    if v > MAX_VIEWS:
        vol = None
        for part in view_chunks(v):
            k = len(src_feas[part])
            vol_k = fused_adaptive_cost_volume(ref_fea, src_feas[part], ref_proj,
                                               src_projs[part], depth_values,
                                               w1, b1, w2, b2, align_corners).float() * (k / v)
            vol = vol_k if vol is None else vol + vol_k
        return vol.to(ref_fea.dtype)
    L = prepare_views("fused_adaptive_cost_volume", ref_fea, src_feas, ref_proj,
                      src_projs, depth_values, align_corners)
    params = _params(w1, b1, w2, b2, L)
    if torch.is_grad_enabled() and (params.requires_grad or ref_fea.requires_grad
                                    or any(s.requires_grad for s in src_feas)):
        return _FusedCostVolume.apply(L, params, ref_fea, *src_feas)
    return _launch_forward(L, params, ref_fea, src_feas)


def fused_adaptive_cost_volume_backward(grad_out: torch.Tensor,
                                        ref_fea: torch.Tensor,
                                        src_feas: Sequence[torch.Tensor],
                                        ref_proj: torch.Tensor,
                                        src_projs: Sequence[torch.Tensor],
                                        depth_values: torch.Tensor,
                                        w1, b1, w2, b2, align_corners: bool = False):
    """K3 on its own: the gradients of sum(volume * grad_out) with respect
    to (ref_fea, src_feas, w1, b1, w2, b2), returned as (dref, [dsrc_v],
    dw1 [C], db1, dw2, db2); the features' gradients in their dtype, the
    weight net's in fp32. CPU tensors run the plain version; CUDA tensors
    launch K3 or raise (also past 16 source views: training reaches K3
    through ``fused_adaptive_cost_volume``'s autograd, which splits them)."""
    if ref_fea.device.type == "cpu":
        return fused_adaptive_cost_volume_backward_plain(
            grad_out, ref_fea, src_feas, ref_proj, src_projs, depth_values,
            w1, b1, w2, b2, align_corners)
    L = prepare_views("fused_adaptive_cost_volume_backward", ref_fea, src_feas,
                      ref_proj, src_projs, depth_values, align_corners)
    dref, dsrc, dw = _launch_backward(L, _params(w1, b1, w2, b2, L), ref_fea,
                                      src_feas, grad_out)
    c = L.c
    return dref, dsrc, dw[:c], dw[c], dw[c + 1], dw[c + 2]


fused_adaptive_cost_volume.launches = 0
fused_adaptive_cost_volume_backward.launches = 0
