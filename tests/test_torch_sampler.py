"""Kernel K4 (the plane-sweep sampler): the port's ``plane_sweep_sample`` on
CPU tensors (its plain version, ``ops.warp.plane_sweep_warp``) against the
JAX Pallas kernel ``sample_bilinear_band`` in interpret mode, on the same
numpy inputs, with windows that cover the rig (overflow flag 0).

Tolerances are the JAX package's own for that kernel against its XLA path
(tests/test_pallas_sampler.py): 5e-5 on the small rig, where the two order
the fp32 geometry differently; 1e-3 on the W=384 rig, where the fp32
rounding of ~1e5-scale intermediates leaves ~1e-3 px of coordinate jitter.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from damvsnet_tpu.ops.pallas.sweep_sampler import plane_sweep_warp_pallas
from damvsnet_tpu.ops.warp import plane_sweep_warp as jwarp
from damvsnet_tpu_torch.ops import warp
from damvsnet_tpu_torch.ops.kernels.sweep_sampler import plane_sweep_sample
from torch_helpers import fused_projs

torch.set_num_threads(1)

B, H, W, D = 2, 24, 32, 4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _depths(rng, per_pixel, b=B, h=H, w=W):
    if per_pixel:
        return (4 + 4 * rng.random((b, D, h, w))).astype(np.float32)
    return np.linspace(4, 8, D, dtype=np.float32)[None].repeat(b, 0)


def _pallas(src, src_p, ref_p, dv, **opts):
    got, overflow = plane_sweep_warp_pallas(
        jnp.asarray(src), jnp.asarray(src_p), jnp.asarray(ref_p), jnp.asarray(dv),
        interpret=True, return_overflow=True, **opts)
    assert int(np.asarray(overflow).sum()) == 0
    return np.asarray(got)


@pytest.mark.parametrize("c", [8, 32])
@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("per_pixel", [False, True])
def test_sample_matches_pallas(rng, c, align_corners, per_pixel):
    ref_p, src_p = fused_projs(B, 2, H, W)
    src = rng.standard_normal((B, H, W, c)).astype(np.float32)
    dv = _depths(rng, per_pixel)
    want = _pallas(src, src_p, ref_p, dv, align_corners=align_corners, wb=W, band_rows=H)
    launches = plane_sweep_sample.launches
    got = plane_sweep_sample(_t(src), _t(src_p), _t(ref_p), _t(dv), align_corners)
    assert plane_sweep_sample.launches == launches  # the CPU runs the plain version
    assert got.dtype == torch.float32 and got.shape == (B, D, H, W, c)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5)


def test_sample_multiblock_default_windows(rng):
    """W=384 with the TPU kernel's production windows (several 128-pixel
    x-blocks, sub-band slicing, lookahead staging) on a narrow-FOV rig."""
    wm, c = 384, 8
    intr = np.array([[0.8 * wm, 0.0, wm / 2], [0.0, 0.8 * wm, H / 2], [0.0, 0.0, 1.0]],
                    np.float32)
    fused = []
    for v in range(2):
        a = 0.05 * v
        ext = np.eye(4, dtype=np.float32)
        ext[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        ext[:3, 3] = [0.3 * v, 0.1 * v, 0.0]
        f = np.eye(4, dtype=np.float32)
        f[:3, :4] = intr @ ext[:3, :4]
        fused.append(f[None])
    ref_p, src_p = fused
    src = rng.standard_normal((1, H, wm, c)).astype(np.float32)
    dv = np.linspace(4, 8, D, dtype=np.float32)[None]
    want = _pallas(src, src_p, ref_p, dv)
    got = plane_sweep_sample(_t(src), _t(src_p), _t(ref_p), _t(dv))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)


def test_camera_looking_away_gives_zeros(rng):
    """Every hypothesis lands far off the source image: all taps are out of
    bounds, so the sample is exactly zero (as the TPU kernel's is)."""
    ref_p, _ = fused_projs(B, 2, H, W)
    src = rng.standard_normal((B, H, W, 8)).astype(np.float32)
    away = np.broadcast_to(np.eye(4, dtype=np.float32), (B, 4, 4)).copy()
    away[:, 0, 3] = 1e6
    dv = _depths(rng, False)
    want = _pallas(src, away, ref_p, dv, wb=W, band_rows=H)
    got = plane_sweep_sample(_t(src), _t(away), _t(ref_p), _t(dv))
    np.testing.assert_array_equal(got.numpy(), 0.0)
    np.testing.assert_allclose(want, 0.0, atol=1e-6)


@pytest.mark.parametrize("per_pixel", [False, True])
def test_plain_warp_align_corners_matches_xla(rng, per_pixel):
    """The plain version with align_corners=True against the JAX XLA warp."""
    ref_p, src_p = fused_projs(B, 2, H, W)
    src = rng.standard_normal((B, H, W, 5)).astype(np.float32)
    dv = _depths(rng, per_pixel)
    want = jwarp(jnp.asarray(src), jnp.asarray(src_p), jnp.asarray(ref_p), jnp.asarray(dv),
                 align_corners=True)
    got = warp.plane_sweep_warp(_t(src), _t(src_p), _t(ref_p), _t(dv), align_corners=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)


def test_sample_keeps_source_dtype(rng):
    """bf16 features give a bf16 sample: the fp32 sample of the bf16 inputs,
    rounded once (the kernel's contract)."""
    ref_p, src_p = fused_projs(B, 2, H, W)
    src = _t(rng.standard_normal((B, H, W, 16)).astype(np.float32)).to(torch.bfloat16)
    dv = _t(_depths(rng, True))
    got = plane_sweep_sample(src, _t(src_p), _t(ref_p), dv)
    want = warp.plane_sweep_warp(src.float(), _t(src_p), _t(ref_p), dv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want.to(torch.bfloat16).float().numpy())
