"""The JAX package's library names that no path of the port calls, held
against JAX on the CPU on inputs from a numpy seed: the camera model and
``fuse_proj`` (numpy), the soft-argmin ``depth_regression``, CasMVSNet's
fixed-interval samplers, the schedule function
``warmup_multistep_schedule``, and ``CascadeMVSNet``'s ``base_channels``
and ``depth_intervals_ratio`` fields."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from damvsnet_tpu.core import cameras as jcameras
from damvsnet_tpu.model import CascadeMVSNet as JCascade
from damvsnet_tpu.ops import regression as jregression
from damvsnet_tpu.ops import sampling as jsampling
from damvsnet_tpu.train import schedule as jschedule
from damvsnet_tpu_torch.core import Camera, fuse_proj
from damvsnet_tpu_torch.model import CascadeMVSNet
from damvsnet_tpu_torch.ops import depth_regression
from damvsnet_tpu_torch.ops.sampling import get_cur_depth_range_samples, get_depth_range_samples
from damvsnet_tpu_torch.train import warmup_multistep_schedule
from torch_helpers import cascade_batch

torch.set_num_threads(1)


def test_fuse_proj():
    """As tests/test_core_io.py holds JAX's, then against JAX's on a seeded
    batch of [B, N, 2, 4, 4] matrices, bitwise."""
    ext = np.eye(4, dtype=np.float32)
    ext[:3, 3] = [1, 2, 3]
    k = np.array([[2.0, 0, 1], [0, 3.0, 2], [0, 0, 1]], np.float32)
    proj = np.zeros((2, 4, 4), np.float32)
    proj[0] = ext
    proj[1, :3, :3] = k
    fused = fuse_proj(proj)
    np.testing.assert_allclose(fused[:3, :4], k @ ext[:3, :4])
    np.testing.assert_allclose(fused[3], ext[3])
    rs = np.random.default_rng(0)
    many = rs.standard_normal((2, 3, 2, 4, 4)).astype(np.float32)
    got = fuse_proj(many)
    assert got.dtype == np.float32 and got.shape == (2, 3, 4, 4)
    np.testing.assert_array_equal(got, jcameras.fuse_proj(many))


def test_camera_fields_scaled_and_proj_mat():
    rs = np.random.default_rng(1)
    k = rs.standard_normal((3, 3)).astype(np.float32)
    e = rs.standard_normal((4, 4)).astype(np.float32)
    fields = dict(depth_min=425.0, depth_interval=2.5, num_depth=192, depth_max=935.0)
    ours, theirs = Camera(k, e, **fields), jcameras.Camera(k, e, **fields)
    for a, b in ((ours, theirs), (ours.scaled(0.5, 0.25), theirs.scaled(0.5, 0.25))):
        np.testing.assert_array_equal(a.intrinsics, b.intrinsics)
        np.testing.assert_array_equal(a.extrinsics, b.extrinsics)
        assert (a.depth_min, a.depth_interval, a.num_depth, a.depth_max) == (
            b.depth_min, b.depth_interval, b.num_depth, b.depth_max)
        assert a.proj_mat().dtype == np.float32
        np.testing.assert_array_equal(a.proj_mat(), b.proj_mat())
    np.testing.assert_array_equal(ours.intrinsics, k)  # scaled() leaves its camera as it was


@pytest.mark.parametrize("per_pixel", [False, True], ids=["BD", "BDHW"])
def test_depth_regression(per_pixel):
    rs = np.random.default_rng(2)
    logits = rs.standard_normal((2, 16, 5, 6)).astype(np.float32)
    p = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    depth = (4 + 4 * rs.random((2, 16, 5, 6) if per_pixel else (2, 16))).astype(np.float32)
    got = depth_regression(torch.from_numpy(p), torch.from_numpy(depth)).numpy()
    want = np.asarray(jregression.depth_regression(jnp.asarray(p), jnp.asarray(depth)))
    assert got.shape == (2, 5, 6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", ["uniform_BD0", "band_BHW", "band_BHW_pixel_interval"])
def test_legacy_depth_range_samples(case):
    """CasMVSNet's dispatcher on a [B, D0] range (the uniform sweep) and on
    a [B, H, W] depth (the fixed-interval band, with a scalar and a
    per-pixel interval), and its band function alone."""
    rs = np.random.default_rng(3)
    ndepth, h, w = 8, 5, 6
    if case == "uniform_BD0":
        cur = np.linspace(4.0, 8.0, 32, dtype=np.float32)[None].repeat(2, 0)
        interval = 0.1
    else:
        cur = (4 + 4 * rs.random((2, h, w))).astype(np.float32)
        interval = (0.05 + 0.1 * rs.random((2, h, w))).astype(np.float32) \
            if case.endswith("pixel_interval") else 0.1
    t_int = torch.from_numpy(interval) if isinstance(interval, np.ndarray) else interval
    j_int = jnp.asarray(interval) if isinstance(interval, np.ndarray) else interval
    got = get_depth_range_samples(torch.from_numpy(cur), ndepth, t_int, h, w).numpy()
    want = np.asarray(jsampling.get_depth_range_samples(jnp.asarray(cur), ndepth, j_int, h, w))
    assert got.shape == (2, ndepth, h, w)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if case != "uniform_BD0":
        band = get_cur_depth_range_samples(torch.from_numpy(cur), ndepth, t_int).numpy()
        np.testing.assert_allclose(band, np.asarray(jsampling.get_cur_depth_range_samples(
            jnp.asarray(cur), ndepth, j_int)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("warmup", [(500, 1.0 / 3), (40, 0.1)], ids=["default", "short"])
def test_warmup_multistep_schedule(warmup):
    """At steps 0, 250, 500 and each milestone +-1. JAX evaluates in fp32
    and the port in fp64: 1e-7 relative."""
    base, milestones, gamma = 1e-3, [4000, 4800, 5600], 0.5
    iters, factor = warmup
    ours = warmup_multistep_schedule(base, milestones, gamma, iters, factor)
    theirs = jschedule.warmup_multistep_schedule(base, milestones, gamma, iters, factor)
    steps = [0, 250, 500] + [m + d for m in milestones for d in (-1, 0, 1)]
    for step in steps:
        np.testing.assert_allclose(ours(step), float(theirs(step)), rtol=1e-7,
                                   err_msg=f"step {step}")
    assert ours(0) == pytest.approx(base * factor) and ours(10**6) == pytest.approx(base / 8)


@pytest.mark.parametrize("base_channels", [4, 16])
def test_base_channels_other_than_8_raise(base_channels):
    """The port builds base_channels=8 alone: the stages' 4x/2x/1x widths
    must be the kernels' C in (8, 16, 32). JAX's model fails with the
    others under geo fusion, its default (a broadcast shape error, seen in
    an abstract init); without geo fusion it builds."""
    batch = cascade_batch(0)
    jargs = (jnp.asarray(batch["imgs"]),
             {k: jnp.asarray(v) for k, v in batch["proj_matrices"].items()},
             jnp.asarray(batch["depth_values"]))
    jmodel = JCascade(ndepths=(16, 8, 8), base_channels=base_channels)
    with pytest.raises(TypeError, match="incompatible shapes for broadcasting"):
        jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), *jargs, train=False))
    for geo in (True, False):
        with pytest.raises(ValueError, match=f"base_channels={base_channels}: .* only 8"):
            CascadeMVSNet(device="cpu", base_channels=base_channels, use_geo_fusion=geo)


def test_depth_intervals_ratio_is_stored_as_jax_stores_it():
    assert JCascade().depth_intervals_ratio == (4, 2, 1)
    assert CascadeMVSNet(device="cpu").depth_intervals_ratio == (4, 2, 1)
    model = CascadeMVSNet(device="cpu", depth_intervals_ratio=(4.0, 2.0, 0.5))
    assert model.depth_intervals_ratio == JCascade(
        depth_intervals_ratio=(4.0, 2.0, 0.5)).depth_intervals_ratio
