"""The PyTorch port's plain ops against their JAX counterparts.

Same inputs, made with numpy from a seed, go through both packages on the
CPU in fp32. Resizes follow torch's own conventions (the JAX package
reimplements them), so they agree to float rounding; the geometry agrees
to fp32 rounding of the projected coordinates.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from damvsnet_tpu.ops import resize as jresize
from damvsnet_tpu.ops import sampling as jsampling
from damvsnet_tpu.ops import warp as jwarp
from damvsnet_tpu.ops.pallas.sweep_sampler import geom_from_projs as jgeom
from damvsnet_tpu_torch.ops import resize, sampling, warp
from torch_helpers import fused_projs

torch.set_num_threads(1)

B, H, W, C, D = 1, 12, 16, 5, 6


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("out_hw", [(24, 32), (48, 64), (6, 8), (17, 23)])
def test_resize_bilinear(rng, out_hw):
    x = rng.standard_normal((2, H, W, C)).astype(np.float32)
    want = jresize.resize_bilinear(jnp.asarray(x), out_hw)
    got = resize.resize_bilinear(_t(x), out_hw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("out_hw", [(24, 32), (6, 8)])
def test_resize_nearest(rng, out_hw):
    x = rng.standard_normal((2, H, W, C)).astype(np.float32)
    want = jresize.resize_nearest(jnp.asarray(x), out_hw)
    got = resize.resize_nearest(_t(x), out_hw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_resize_trilinear_depth_snap(rng):
    """The cascade's snap: full-resolution hypotheses to 1/4 and 1/2."""
    vol = rng.standard_normal((1, D, 4 * H, 4 * W)).astype(np.float32)
    for f in (4, 2):
        out = (D, 4 * H // f, 4 * W // f)
        want = jresize.resize_trilinear_depth(jnp.asarray(vol), out)
        got = resize.resize_trilinear_depth(_t(vol), out)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("per_pixel", [False, True])
def test_plane_sweep_grid(rng, per_pixel):
    ref_p, src_p = fused_projs(B, 2, H, W)
    if per_pixel:
        dv = (4 + 4 * rng.random((B, D, H, W))).astype(np.float32)
    else:
        dv = np.linspace(4, 8, D, dtype=np.float32)[None]
    jpx, jpy = jwarp.plane_sweep_grid(jnp.asarray(src_p), jnp.asarray(ref_p),
                                      jnp.asarray(dv), H, W)
    px, py = warp.plane_sweep_grid(_t(src_p), _t(ref_p), _t(dv), H, W)
    np.testing.assert_allclose(px.numpy(), np.asarray(jpx), atol=2e-5)
    np.testing.assert_allclose(py.numpy(), np.asarray(jpy), atol=2e-5)


def test_geom_from_projs_matches_grid():
    """The kernel's affine form (geom rows, sx = W/(W-1), ox = -0.5) gives
    the grid's coordinates, and the geometry rows match JAX's."""
    ref_p, src_p = fused_projs(B, 2, H, W)
    np.testing.assert_allclose(
        warp.geom_from_projs(_t(src_p), _t(ref_p)).numpy(),
        np.asarray(jgeom(jnp.asarray(src_p), jnp.asarray(ref_p))), atol=1e-5)
    g = warp.geom_from_projs(_t(src_p), _t(ref_p))[0].double().numpy()
    dv = np.linspace(4, 8, D)
    y, x = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    sx, ox = warp.pixel_affine(W)
    sy, oy = warp.pixel_affine(H)
    d = dv[:, None, None]
    nx = (g[0] * x + g[1] * y + g[2]) * d + g[9]
    ny = (g[3] * x + g[4] * y + g[5]) * d + g[10]
    nz = (g[6] * x + g[7] * y + g[8]) * d + g[11]
    px, py = warp.plane_sweep_grid(_t(src_p), _t(ref_p),
                                   _t(dv[None].astype(np.float32)), H, W)
    np.testing.assert_allclose(px[0].numpy(), nx / nz * sx + ox, atol=1e-4)
    np.testing.assert_allclose(py[0].numpy(), ny / nz * sy + oy, atol=1e-4)


def test_bilinear_sample_zeros(rng):
    """Interior, border and out-of-image coordinates (every tap outside
    contributes zero), against JAX's sampler."""
    img = rng.standard_normal((B, H, W, C)).astype(np.float32)
    px = rng.uniform(-3, W + 2, (B, D, H, W)).astype(np.float32)
    py = rng.uniform(-3, H + 2, (B, D, H, W)).astype(np.float32)
    want = jwarp.bilinear_sample_zeros(jnp.asarray(img), jnp.asarray(px),
                                       jnp.asarray(py))
    got = warp.bilinear_sample_zeros(_t(img), _t(px), _t(py))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_bilinear_sample_nonfinite_and_huge_is_zero(rng):
    """A non-finite or huge coordinate samples to zero: bounds are tested in
    float before any integer cast, so nothing wraps into a valid index.
    This is the JAX Pallas kernels' rule; JAX's XLA sampler instead returns
    NaN for a non-finite coordinate (a recorded divergence)."""
    img = rng.standard_normal((B, H, W, C)).astype(np.float32)
    px = np.array([[np.nan, np.inf, -np.inf, 4.3e9, -4.3e9, 2.5]], np.float32)
    py = np.array([[1.5, 1.5, 1.5, 1.5, 1.5, np.nan]], np.float32)
    got = warp.bilinear_sample_zeros(_t(img), _t(px), _t(py))
    np.testing.assert_array_equal(got.numpy(), 0.0)
    xla = np.asarray(jwarp.bilinear_sample_zeros(jnp.asarray(img), jnp.asarray(px),
                                                 jnp.asarray(py)))
    finite = np.isfinite(px[0]) & np.isfinite(py[0])
    assert np.isnan(xla[0, ~finite]).all()
    np.testing.assert_array_equal(xla[0, finite], 0.0)


@pytest.mark.parametrize("per_pixel", [False, True])
def test_plane_sweep_warp_gradient(rng, per_pixel):
    """The gradient of sum(warp * cot) with respect to the source features,
    the depth hypotheses and both projections, against jax.grad in fp32:
    only the features get one (the sampling coordinates are detached, as
    JAX stops them); the depths' and the projections' are zero in both."""
    ref_p, src_p = fused_projs(B, 2, H, W)
    img = rng.standard_normal((B, H, W, C)).astype(np.float32)
    if per_pixel:
        dv = (4 + 4 * rng.random((B, D, H, W))).astype(np.float32)
    else:
        dv = np.linspace(4, 8, D, dtype=np.float32)[None]
    cot = rng.standard_normal((B, D, H, W, C)).astype(np.float32)
    args = (img, src_p, ref_p, dv)

    want = jax.grad(lambda *a: jnp.sum(jwarp.plane_sweep_warp(*a) * cot),
                    argnums=(0, 1, 2, 3))(*map(jnp.asarray, args))
    inputs = [_t(a).requires_grad_() for a in args]
    out = warp.plane_sweep_warp(*inputs)
    got = torch.autograd.grad((out * _t(cot)).sum(), inputs, allow_unused=True,
                              materialize_grads=True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)
    for name, g, jg in zip(("src_proj", "ref_proj", "depth_values"), got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), 0.0, err_msg=name)
        np.testing.assert_array_equal(np.asarray(jg), 0.0, err_msg=name)


@pytest.mark.parametrize("ndepth", [8, 32])
def test_adaptive_depth_samples(rng, ndepth):
    cur = (4 + 4 * rng.random((B, 1, H, W))).astype(np.float32)
    sigma = (0.01 + 2 * rng.random((B, 1, H, W))).astype(np.float32)
    want = jsampling.adaptive_depth_samples(jnp.asarray(cur), jnp.asarray(sigma),
                                            ndepth)
    got = sampling.adaptive_depth_samples(_t(cur), _t(sigma), ndepth)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)


def test_uniform_depth_samples():
    dv = np.linspace(425.0, 935.0, 192, dtype=np.float32)[None]
    want = jsampling.uncertainty_aware_samples(jnp.asarray(dv), None, 64, H, W)
    got = sampling.uncertainty_aware_samples(_t(dv), None, 64, H, W)
    assert got.stride(2) == 0 and got.stride(3) == 0  # never materialized
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
