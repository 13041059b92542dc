"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they need an NVIDIA GPU with nvcc and skip elsewhere. The
file imports no JAX, so on a machine without it run it as
``DAMVSNET_TEST_TPU=1 python -m pytest tests/test_torch_kernels_cuda.py -m cuda``
(the variable keeps tests/conftest.py from importing JAX).

Tolerances: fp32 runs with TF32 off; the kernel and the plain version order
the projective geometry and the sums differently, so values differ by fp32
rounding amplified by the feature gradient at the sampled point (1e-4 here,
with smooth features). In bf16 both sum in fp32 and round once, so they
differ by at most one bf16 step (2^-7 relative) where the fp32 sums straddle
a rounding boundary.
"""
import pytest
import torch

from damvsnet_tpu_torch.ops.kernels import fused_costvol, probstats
from damvsnet_tpu_torch.ops.kernels.sweep_sampler import plane_sweep_sample
from damvsnet_tpu_torch.ops.regression import prob_volume_stats
from damvsnet_tpu_torch.ops.warp import plane_sweep_warp
from torch_helpers import fused_projs

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, dtype, c, per_pixel, b=1, h=24, w=40, d=6, views=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    fused = [torch.from_numpy(f).to(dev)
             for f in fused_projs(b, views, h, w, seed=seed)]
    # smooth features: a low-resolution field upsampled, as real feature
    # maps are smooth at the scale of the sampling error
    feas = [torch.nn.functional.interpolate(
        torch.randn(b, c, h // 4, w // 4, generator=g), size=(h, w),
        mode="bilinear").permute(0, 2, 3, 1).contiguous().to(dev, dtype)
        for _ in range(views)]
    if per_pixel:
        dv = 4 + 4 * torch.rand(b, d, h, w, generator=g)
    else:
        dv = torch.linspace(4, 8, d)[None].repeat(b, 1)
    w1 = torch.rand(c, generator=g) - 0.3
    scal = torch.tensor([0.1, 0.7, -0.05])
    return feas, fused, dv.to(dev), w1.to(dev), *scal.to(dev)


@pytest.mark.parametrize("c", [8, 16, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("per_pixel", [False, True])
def test_fused_costvol_matches_plain(dev, c, dtype, per_pixel):
    feas, projs, dv, w1, b1, w2, b2 = _inputs(dev, dtype, c, per_pixel)
    args = (feas[0], feas[1:], projs[0], projs[1:], dv, w1, b1, w2, b2)
    n0 = fused_costvol.fused_adaptive_cost_volume.launches
    got = fused_costvol.fused_adaptive_cost_volume(*args)
    torch.cuda.synchronize()
    assert fused_costvol.fused_adaptive_cost_volume.launches == n0 + 1
    want = fused_costvol.fused_adaptive_cost_volume_plain(*args)
    assert got.dtype == dtype and got.shape == want.shape
    rel = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    tol = 1e-4 + rel * want.float().abs()
    assert bool(((got.float() - want.float()).abs() <= tol).all())


def test_fused_costvol_rejects_bad_input(dev):
    feas, projs, dv, w1, b1, w2, b2 = _inputs(dev, torch.float32, 8, False)
    with pytest.raises(ValueError):
        fused_costvol.fused_adaptive_cost_volume(
            feas[0][..., :4].contiguous(), [f[..., :4].contiguous() for f in feas[1:]],
            projs[0], projs[1:], dv, w1[:4], b1, w2, b2)
    with pytest.raises(ValueError):
        fused_costvol.fused_adaptive_cost_volume(
            feas[0], feas[1:], projs[0], projs[1:], dv.cpu(), w1, b1, w2, b2)


@pytest.mark.parametrize("per_pixel", [False, True])
def test_probstats_matches_plain(dev, per_pixel):
    g = torch.Generator().manual_seed(1)
    b, d, h, w = 2, 32, 24, 40
    cost = (3 * torch.randn(b, d, h, w, generator=g)).to(dev)
    if per_pixel:
        dv = (4 + 4 * torch.rand(b, d, h, w, generator=g)).sort(dim=1).values.to(dev)
    else:
        dv = torch.linspace(4, 8, d)[None].repeat(b, 1).to(dev)
    n0 = probstats.prob_volume_stats_fused.launches
    got = probstats.prob_volume_stats_fused(cost, dv)
    torch.cuda.synchronize()
    assert probstats.prob_volume_stats_fused.launches == n0 + 1
    want = prob_volume_stats(cost, dv)
    for key, atol in (("prob_volume", 1e-6), ("depth", 1e-5), ("variance", 1e-5)):
        torch.testing.assert_close(got[key], want[key], atol=atol, rtol=0)
    flips = (got["photometric_confidence"] - want["photometric_confidence"]).abs() > 1e-5
    assert int(flips.sum()) <= 2


@pytest.mark.parametrize("c", [8, 16, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("per_pixel", [False, True])
def test_fused_costvol_backward_matches_plain(dev, c, dtype, per_pixel):
    """K3 against torch autograd of the plain forward (in fp32 on the same
    inputs); fp32 atomics sum in another order on every run."""
    feas, projs, dv, w1, b1, w2, b2 = _inputs(dev, dtype, c, per_pixel, b=2)
    g = torch.Generator(device=dev).manual_seed(3)
    cot = torch.randn((2, dv.shape[1], 24, 40, c), generator=g, device=dev).to(dtype)
    args = (feas[0], feas[1:], projs[0], projs[1:], dv, w1, b1, w2, b2)
    n0 = fused_costvol.fused_adaptive_cost_volume_backward.launches
    got = fused_costvol.fused_adaptive_cost_volume_backward(cot, *args)
    torch.cuda.synchronize()
    assert fused_costvol.fused_adaptive_cost_volume_backward.launches == n0 + 1
    want = fused_costvol.fused_adaptive_cost_volume_backward_plain(
        cot.float(), feas[0].float(), [f.float() for f in feas[1:]], projs[0],
        projs[1:], dv, w1, b1, w2, b2)
    rel = 1e-4 if dtype == torch.float32 else 2.0 ** -8
    for gt, wt in [(got[0], want[0])] + list(zip(got[1], want[1])):
        assert gt.dtype == dtype and gt.shape == wt.shape
        tol = 1e-3 * wt.abs().max() + rel * wt.abs()
        assert bool(((gt.float() - wt).abs() <= tol).all())
    gw = torch.cat([got[2], torch.stack(got[3:])])
    ww = torch.cat([want[2], torch.stack(want[3:])])
    assert float((gw - ww).abs().max()) <= 1e-3 * float(ww.abs().max())


def test_fused_costvol_function_gradients(dev):
    """Autograd through the wrapper: forward K1, backward K3, gradients to
    the features and to w1..b2 through the fold, none to the geometry."""
    feas, projs, dv, w1, b1, w2, b2 = _inputs(dev, torch.float32, 16, True, b=2)
    leaves = [f.clone().requires_grad_() for f in feas]
    wts = [t.clone().requires_grad_() for t in (w1, b1, w2, b2)]
    n0 = (fused_costvol.fused_adaptive_cost_volume.launches,
          fused_costvol.fused_adaptive_cost_volume_backward.launches)
    vol = fused_costvol.fused_adaptive_cost_volume(
        leaves[0], leaves[1:], projs[0], projs[1:], dv, *wts)
    (vol * vol.detach().sin()).sum().backward()
    assert (fused_costvol.fused_adaptive_cost_volume.launches,
            fused_costvol.fused_adaptive_cost_volume_backward.launches) == (n0[0] + 1, n0[1] + 1)
    ref_leaves = [f.clone().requires_grad_() for f in feas]
    ref_wts = [t.clone().requires_grad_() for t in (w1, b1, w2, b2)]
    want = fused_costvol.fused_adaptive_cost_volume_plain(
        ref_leaves[0], ref_leaves[1:], projs[0], projs[1:], dv, *ref_wts)
    (want * vol.detach().sin()).sum().backward()
    for a, b in zip(leaves + wts, ref_leaves + ref_wts):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-3 * float(b.grad.abs().max()),
                                   rtol=1e-4)


def test_fused_costvol_backward_rejects_bad_cotangent(dev):
    feas, projs, dv, w1, b1, w2, b2 = _inputs(dev, torch.float32, 8, False)
    args = (feas[0], feas[1:], projs[0], projs[1:], dv, w1, b1, w2, b2)
    cot = torch.ones((1, dv.shape[1], 24, 40, 8), device=dev)
    with pytest.raises(ValueError):
        fused_costvol.fused_adaptive_cost_volume_backward(cot.bfloat16(), *args)
    with pytest.raises(ValueError):
        fused_costvol.fused_adaptive_cost_volume_backward(cot.transpose(2, 3).contiguous()
                                                          .transpose(2, 3), *args)


@pytest.mark.parametrize("c", [8, 16, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("per_pixel", [False, True])
@pytest.mark.parametrize("align_corners", [False, True])
def test_sweep_sampler_matches_plain(dev, c, dtype, per_pixel, align_corners):
    """K4 against its plain version (fp32, on the same inputs); in bf16 the
    kernel rounds its fp32 sample once."""
    feas, projs, dv, *_ = _inputs(dev, dtype, c, per_pixel, b=2, views=2)
    n0 = plane_sweep_sample.launches
    with torch.no_grad():
        got = plane_sweep_sample(feas[1], projs[1], projs[0], dv, align_corners)
    torch.cuda.synchronize()
    assert plane_sweep_sample.launches == n0 + 1
    want = plane_sweep_warp(feas[1], projs[1], projs[0], dv, align_corners)
    assert got.dtype == dtype and got.shape == want.shape and got.is_contiguous()
    rel = 1e-4 if dtype == torch.float32 else 2.0 ** -8
    tol = 1e-4 + rel * want.abs()
    assert bool(((got.float() - want).abs() <= tol).all())


def test_sweep_sampler_batch_stride(dev):
    """A view of a [B, N, H, W, C] stack (the cascade's source features)
    samples exactly as the same features laid out on their own."""
    feas, projs, dv, *_ = _inputs(dev, torch.bfloat16, 16, True, b=2, views=3)
    stacked = torch.stack(feas, dim=1)
    with torch.no_grad():
        got = plane_sweep_sample(stacked[:, 2], projs[2], projs[0], dv)
        want = plane_sweep_sample(feas[2], projs[2], projs[0], dv)
    assert torch.equal(got, want)


def test_sweep_sampler_rejects_bad_input(dev):
    feas, projs, dv, *_ = _inputs(dev, torch.float32, 8, False, views=2)
    with pytest.raises(ValueError):  # C not in (8, 16, 32)
        plane_sweep_sample(feas[1][..., :4].contiguous(), projs[1], projs[0], dv)
    with pytest.raises(ValueError):  # the depths on another device
        plane_sweep_sample(feas[1], projs[1], projs[0], dv.cpu())
    with pytest.raises(ValueError):  # the [H, W, C] plane not contiguous
        plane_sweep_sample(feas[1].transpose(1, 2).contiguous().transpose(1, 2),
                           projs[1], projs[0], dv)
    with pytest.raises(ValueError):  # fp16
        plane_sweep_sample(feas[1].half(), projs[1], projs[0], dv)
    with pytest.raises(RuntimeError, match="inference-only"):
        plane_sweep_sample(feas[1].clone().requires_grad_(), projs[1], projs[0], dv)
