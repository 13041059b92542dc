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
import types

import pytest
import torch
import torch.nn.functional as F

from damvsnet_tpu_torch.nn import costreg
from damvsnet_tpu_torch.ops.costvol import variance_cost_volume
from damvsnet_tpu_torch.ops.kernels import _common, fused_costvol, prob_conv, probstats
from damvsnet_tpu_torch.ops.kernels import linear_attention as la
from damvsnet_tpu_torch.ops.kernels.sweep_sampler import plane_sweep_sample, plane_sweep_variance
from damvsnet_tpu_torch.ops.regression import prob_volume_stats
from damvsnet_tpu_torch.ops.warp import plane_sweep_grid, plane_sweep_warp
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
@pytest.mark.parametrize("align_corners", [False, True])
def test_fused_costvol_matches_plain(dev, c, dtype, per_pixel, align_corners):
    feas, projs, dv, w1, b1, w2, b2 = _inputs(dev, dtype, c, per_pixel)
    args = (feas[0], feas[1:], projs[0], projs[1:], dv, w1, b1, w2, b2, align_corners)
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
@pytest.mark.parametrize("align_corners", [False, True])
def test_fused_costvol_backward_matches_plain(dev, c, dtype, per_pixel, align_corners):
    """K3 against torch autograd of the plain forward (in fp32 on the same
    inputs); fp32 atomics sum in another order on every run."""
    feas, projs, dv, w1, b1, w2, b2 = _inputs(dev, dtype, c, per_pixel, b=2)
    g = torch.Generator(device=dev).manual_seed(3)
    cot = torch.randn((2, dv.shape[1], 24, 40, c), generator=g, device=dev).to(dtype)
    args = (feas[0], feas[1:], projs[0], projs[1:], dv, w1, b1, w2, b2, align_corners)
    n0 = fused_costvol.fused_adaptive_cost_volume_backward.launches
    got = fused_costvol.fused_adaptive_cost_volume_backward(cot, *args)
    torch.cuda.synchronize()
    assert fused_costvol.fused_adaptive_cost_volume_backward.launches == n0 + 1
    want = fused_costvol.fused_adaptive_cost_volume_backward_plain(
        cot.float(), feas[0].float(), [f.float() for f in feas[1:]], projs[0],
        projs[1:], dv, w1, b1, w2, b2, align_corners)
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


# --- K1 and K3 as redesigned: lane groups over 16-byte channel pieces, K3's
# shared-memory window of the source plane and its flushes


def _rig(dev, b, views, h, w, baseline=0.1, zoom=1.0, shift=0.0):
    """Fused projections [B, 4, 4] of cameras side by side on a baseline;
    the sources' focal length ``zoom`` times the reference's (a tile's taps
    spread ``zoom`` times wider) and shifted by ``shift`` along x."""
    projs = []
    for v in range(views):
        f = 1.2 * w * (zoom if v else 1.0)
        k = torch.tensor([[f, 0.0, w / 2], [0.0, f, h / 2], [0.0, 0.0, 1.0]])
        p = torch.eye(4)
        p[:3, :3] = k
        p[:3, 3] = k @ torch.tensor([baseline * v + (shift if v else 0.0), 0.3 * baseline * v, 0.0])
        projs.append(p.expand(b, 4, 4).contiguous().to(dev))
    return projs


def _smooth_features(dev, dtype, b, h, w, c, views, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.nn.functional.interpolate(
        torch.randn(b, c, max(h // 4, 2), max(w // 4, 2), generator=g), size=(h, w),
        mode="bilinear").permute(0, 2, 3, 1).contiguous().to(dev, dtype)
        for _ in range(views)]


def _weights(dev, c, seed=0):
    g = torch.Generator().manual_seed(seed + 100)
    return (torch.rand(c, generator=g).to(dev) - 0.3,
            *torch.tensor([0.1, 0.7, -0.05]).to(dev))


def _k3(dev, dtype, feas, projs, dv, wts, seed=3):
    """(K3's gradients, autograd of the plain forward in fp32) on a seeded
    cotangent."""
    b, h, w, c = feas[0].shape
    g = torch.Generator(device=dev).manual_seed(seed)
    cot = torch.randn((b, dv.shape[1], h, w, c), generator=g, device=dev).to(dtype)
    args = (feas[0], feas[1:], projs[0], projs[1:], dv, *wts)
    n0 = fused_costvol.fused_adaptive_cost_volume_backward.launches
    got = fused_costvol.fused_adaptive_cost_volume_backward(cot, *args)
    torch.cuda.synchronize()
    assert fused_costvol.fused_adaptive_cost_volume_backward.launches == n0 + 1
    want = fused_costvol.fused_adaptive_cost_volume_backward_plain(
        cot.float(), feas[0].float(), [f.float() for f in feas[1:]], projs[0], projs[1:],
        dv, *wts)
    return got, want


def _assert_k3_close(got, want, dtype):
    """chip_smoke.py's K3_TOL: per feature gradient, relative L2 <= 2e-3
    (fp32) or 2^-8 + 2e-3 (bf16), and elementwise |d| <= rel * |plain| +
    2e-2 * max |plain|. Not tighter elementwise: where the two order <w1, d2>
    differently, a weight-net ReLU input within rounding of zero can take
    the other side, and a few gradient entries move by percents (both
    kernel versions show it at the same entries)."""
    l2, rel = (2e-3, 0.0) if dtype == torch.float32 else (2.0 ** -8 + 2e-3, 2.0 ** -8)
    for gt, wt in [(got[0], want[0])] + list(zip(got[1], want[1])):
        assert gt.dtype == dtype and gt.shape == wt.shape
        d = gt.float() - wt
        norm = float(torch.linalg.vector_norm(wt))
        assert (float(torch.linalg.vector_norm(d)) <= l2 * norm if norm > 0
                else not bool(gt.any()))
        assert bool((d.abs() <= rel * wt.abs() + 2e-2 * wt.abs().max()).all())
    gw = torch.cat([got[2], torch.stack(got[3:])])
    ww = torch.cat([want[2], torch.stack(want[3:])])
    assert float((gw - ww).abs().max()) <= 1e-3 * float(ww.abs().max())


def _sweep(dev, kind, b, d, h, w, seed=5):
    """"uniform": a [B, D] sweep over 4..8; "random": per-pixel hypotheses
    over the whole range, unsorted; "narrow": a band of 0.1 around a smooth
    depth map, as ADIA's."""
    g = torch.Generator().manual_seed(seed)
    if kind == "uniform":
        dv = torch.linspace(4, 8, d)[None].repeat(b, 1)
    elif kind == "random":
        dv = 4 + 4 * torch.rand(b, d, h, w, generator=g)
    else:
        centre = 5 + torch.nn.functional.interpolate(
            torch.rand(b, 1, 3, 3, generator=g), size=(h, w), mode="bilinear")
        dv = centre + torch.linspace(-0.05, 0.05, d)[None, :, None, None]
    return dv.to(dev)


@pytest.mark.parametrize("c", [8, 16, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["baseline", "zoom", "random"])
def test_fused_costvol_backward_window_flushes(dev, c, dtype, case):
    """K3 where its window must flush and re-anchor: a wide baseline under a
    uniform sweep (the footprint crosses the window along D), sources at 4x
    the focal length (a tile's footprint wider than the window), and
    per-pixel hypotheses over the whole range (neighbours far apart)."""
    b, h, w, views = 2, 48, 80, 3
    projs = _rig(dev, b, views, h, w, baseline=0.6 if case == "baseline" else 0.1,
                 zoom=4.0 if case == "zoom" else 1.0)
    feas = _smooth_features(dev, dtype, b, h, w, c, views)
    dv = _sweep(dev, "random" if case == "random" else "uniform", b, 12, h, w)
    got, want = _k3(dev, dtype, feas, projs, dv, _weights(dev, c))
    _assert_k3_close(got, want, dtype)


@pytest.mark.parametrize("c", [8, 16, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("per_pixel", [False, True])
def test_fused_costvol_tile_edges(dev, c, dtype, per_pixel):
    """H, W and D that are multiples of no tile, run or block: K1 against
    its plain version, K3 against autograd of it."""
    b, h, w, d, views = 2, 37, 53, 11, 3
    projs = _rig(dev, b, views, h, w)
    feas = _smooth_features(dev, dtype, b, h, w, c, views)
    dv = _sweep(dev, "random" if per_pixel else "uniform", b, d, h, w)
    wts = _weights(dev, c)
    args = (feas[0], feas[1:], projs[0], projs[1:], dv, *wts)
    got = fused_costvol.fused_adaptive_cost_volume(*args)
    want = fused_costvol.fused_adaptive_cost_volume_plain(*args)
    rel = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    assert bool(((got.float() - want.float()).abs() <= 1e-4 + rel * want.float().abs()).all())
    _assert_k3_close(*_k3(dev, dtype, feas, projs, dv, wts), dtype)


@pytest.mark.parametrize("views", [1, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_costvol_view_counts(dev, views, dtype):
    """V=1 and V=16 (MAX_VIEWS) source views, K1 and K3."""
    b, h, w, c = 1, 24, 40, 16
    projs = _rig(dev, b, views + 1, h, w, baseline=0.02)
    feas = _smooth_features(dev, dtype, b, h, w, c, views + 1)
    dv = _sweep(dev, "narrow", b, 6, h, w)
    wts = _weights(dev, c)
    args = (feas[0], feas[1:], projs[0], projs[1:], dv, *wts)
    got = fused_costvol.fused_adaptive_cost_volume(*args)
    want = fused_costvol.fused_adaptive_cost_volume_plain(*args)
    rel = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    assert bool(((got.float() - want.float()).abs() <= 1e-4 + rel * want.float().abs()).all())
    _assert_k3_close(*_k3(dev, dtype, feas, projs, dv, wts), dtype)


@pytest.mark.parametrize("c", [8, 32])
def test_fused_costvol_backward_batch_stride(dev, c):
    """B=2 sources that are views of one stacked [B, N, H, W, C] tensor
    (one batch stride for all views), as the serving cascade passes them."""
    b, h, w, views = 2, 24, 40, 4
    projs = _rig(dev, b, views, h, w)
    stacked = torch.stack(_smooth_features(dev, torch.bfloat16, b, h, w, c, views), dim=1)
    feas = [stacked[:, v] for v in range(views)]
    assert feas[1].stride(0) == views * h * w * c
    dv = _sweep(dev, "narrow", b, 8, h, w)
    got, want = _k3(dev, torch.bfloat16, feas, projs, dv, _weights(dev, c))
    _assert_k3_close(got, want, torch.bfloat16)


def test_fused_costvol_backward_all_taps_outside(dev):
    """A source camera whose taps all fall outside its image: its gradient
    is exactly zero, and the reference's still matches."""
    b, h, w, c, views = 2, 24, 40, 16, 3
    projs = _rig(dev, b, views, h, w, shift=1e3)
    feas = _smooth_features(dev, torch.float32, b, h, w, c, views)
    dv = _sweep(dev, "uniform", b, 8, h, w)
    got, want = _k3(dev, torch.float32, feas, projs, dv, _weights(dev, c))
    for g in got[1]:
        assert not bool(g.any())
    _assert_k3_close(got, want, torch.float32)


def test_fused_costvol_backward_repeats(dev):
    """Two K3 runs on the same inputs: fp32 atomics add in another order
    each run, so they agree within the relative L2 tolerance of
    chip_smoke.py's K3_TOL (2e-3 in fp32)."""
    b, h, w, c, views = 2, 48, 80, 32, 4
    projs = _rig(dev, b, views, h, w, baseline=0.6)
    feas = _smooth_features(dev, torch.float32, b, h, w, c, views)
    dv = _sweep(dev, "random", b, 8, h, w)
    wts = _weights(dev, c)
    cot = torch.randn((b, 8, h, w, c), device=dev)
    args = (feas[0], feas[1:], projs[0], projs[1:], dv, *wts)
    one = fused_costvol.fused_adaptive_cost_volume_backward(cot, *args)
    two = fused_costvol.fused_adaptive_cost_volume_backward(cot, *args)
    for a, z in [(one[0], two[0])] + list(zip(one[1], two[1])):
        assert float(torch.linalg.vector_norm(a - z) / torch.linalg.vector_norm(z)) <= 2e-3


@pytest.mark.parametrize("c", [8, 16, 32])
def test_fused_costvol_backward_window_cuts_atomics(dev, c):
    """Narrow per-pixel hypotheses: the window's flushes take at most a
    quarter of the 16-byte atomics that scattering every tap would take
    (valid taps x C/4, counted on the plain grid)."""
    b, h, w, d, views = 2, 64, 96, 16, 4
    projs = _rig(dev, b, views, h, w)
    feas = _smooth_features(dev, torch.bfloat16, b, h, w, c, views)
    dv = _sweep(dev, "narrow", b, d, h, w)
    L = _common.prepare_views("k3", feas[0], feas[1:], projs[0], projs[1:], dv)
    params = fused_costvol._params(*_weights(dev, c), L)
    cot = torch.randn((b, d, h, w, c), device=dev).bfloat16()
    counter = torch.zeros(1, dtype=torch.int64, device=dev)
    fused_costvol._launch_backward(L, params, feas[0], feas[1:], cot, atomics=counter)
    direct = 0
    for p in projs[1:]:
        px, py = plane_sweep_grid(p, projs[0], dv, h, w)
        x0, y0 = px.floor(), py.floor()
        for ox in (0, 1):
            for oy in (0, 1):
                x, y = x0 + ox, y0 + oy
                direct += int(((x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)).sum())
    direct *= c // 4
    assert 0 < int(counter) <= direct // 4


# --- K4's variance entry and K2 as redesigned


@pytest.mark.parametrize("c", [8, 16, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("align_corners", [False, True])
def test_sweep_variance_matches_plain(dev, c, dtype, align_corners):
    """K4's variance entry against its plain version on the same inputs in
    fp32: W = 53 and H = 37 fill no block of pixels (P = 16..128), per-pixel
    hypotheses over the whole range and a wide baseline put many taps off
    the image. In bf16 the kernel rounds its fp32 variance once (half a
    step, 2^-8 relative). One launch for all views; the sampler's counter
    does not move."""
    b, h, w, d, views = 2, 37, 53, 11, 4
    projs = _rig(dev, b, views, h, w, baseline=0.6)
    feas = _smooth_features(dev, dtype, b, h, w, c, views)
    dv = _sweep(dev, "random", b, d, h, w)
    n0 = (plane_sweep_variance.launches, plane_sweep_sample.launches)
    with torch.no_grad():
        got = plane_sweep_variance(feas[0], feas[1:], projs[0], projs[1:], dv, align_corners)
    torch.cuda.synchronize()
    assert (plane_sweep_variance.launches, plane_sweep_sample.launches) == (n0[0] + 1, n0[1])
    want = variance_cost_volume(feas[0].float(), [f.float() for f in feas[1:]], projs[0],
                                projs[1:], dv, warp=plane_sweep_warp,
                                align_corners=align_corners)
    assert got.dtype == dtype and got.shape == want.shape and got.is_contiguous()
    # some hypotheses sample outside the source images
    px, _ = plane_sweep_grid(projs[-1], projs[0], dv, h, w, align_corners)
    assert bool((px < -1).any() | (px > w).any())
    rel = 1e-4 if dtype == torch.float32 else 2.0 ** -8
    assert bool(((got.float() - want).abs() <= 1e-4 + rel * want.abs()).all())


@pytest.mark.parametrize("views", [1, 16])
@pytest.mark.parametrize("per_pixel", [False, True])
def test_sweep_variance_view_counts(dev, views, per_pixel):
    """V = 1 and V = 16 source views, a [B, D] sweep or per-pixel depths,
    and sources that are views of one stacked [B, N, H, W, C] tensor."""
    b, h, w, c = 2, 24, 40, 16
    projs = _rig(dev, b, views + 1, h, w, baseline=0.02)
    stacked = torch.stack(_smooth_features(dev, torch.float32, b, h, w, c, views + 1), dim=1)
    feas = [stacked[:, v] for v in range(views + 1)]
    dv = _sweep(dev, "narrow" if per_pixel else "uniform", b, 6, h, w)
    with torch.no_grad():
        got = plane_sweep_variance(feas[0], feas[1:], projs[0], projs[1:], dv)
    want = variance_cost_volume(feas[0], feas[1:], projs[0], projs[1:], dv)
    assert bool(((got - want).abs() <= 1e-4 + 1e-4 * want.abs()).all())


def test_sweep_variance_rejects_bad_input(dev):
    feas, projs, dv, *_ = _inputs(dev, torch.float32, 8, True, views=3)
    with torch.no_grad():
        with pytest.raises(ValueError):  # C not in (8, 16, 32)
            plane_sweep_variance(feas[0][..., :4].contiguous(),
                                 [f[..., :4].contiguous() for f in feas[1:]],
                                 projs[0], projs[1:], dv)
        with pytest.raises(ValueError):  # the views' dtypes differ
            plane_sweep_variance(feas[0], [feas[1].bfloat16(), feas[2]], projs[0], projs[1:], dv)
        with pytest.raises(ValueError):  # the depths on another device
            plane_sweep_variance(feas[0], feas[1:], projs[0], projs[1:], dv.cpu())
    with pytest.raises(RuntimeError, match="inference-only"):
        plane_sweep_variance(feas[0].clone().requires_grad_(), feas[1:], projs[0], projs[1:], dv)


@pytest.mark.parametrize("views", [17, 33])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_past_max_views(dev, views, dtype):
    """More source views than one launch takes (MAX_VIEWS = 16): K1 splits
    them into even launches of at most 16 (17: 8 + 9), forward and, through
    autograd, K3; K4's variance entry runs the variance over its sampler,
    one launch per view. Each against its plain version (the variance in
    fp32 on the same inputs), at K1's limits above."""
    b, h, w, c, d = 1, 24, 40, 16, 6
    projs = _rig(dev, b, views + 1, h, w, baseline=0.02)
    feas = _smooth_features(dev, dtype, b, h, w, c, views + 1)
    dv = _sweep(dev, "narrow", b, d, h, w)
    wts = _weights(dev, c)
    rel = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    chunks = -(-views // _common.MAX_VIEWS)

    k1, k3 = (fused_costvol.fused_adaptive_cost_volume,
              fused_costvol.fused_adaptive_cost_volume_backward)
    n0 = (k1.launches, k3.launches)
    leaves = [f.clone().requires_grad_() for f in feas]
    got = k1(leaves[0], leaves[1:], projs[0], projs[1:], dv, *wts)
    cot = got.detach().float().sin()
    (got.float() * cot).sum().backward()
    assert (k1.launches, k3.launches) == (n0[0] + chunks, n0[1] + chunks)
    ref = [f.float().clone().requires_grad_() for f in feas]
    want = fused_costvol.fused_adaptive_cost_volume_plain(ref[0], ref[1:], projs[0], projs[1:],
                                                          dv, *wts)
    (want * cot).sum().backward()
    assert got.dtype == dtype
    assert bool(((got.float() - want).abs() <= 1e-4 + rel * want.abs()).all())
    for a, r in zip(leaves, ref):
        d_ = a.grad.float() - r.grad
        assert float(torch.linalg.vector_norm(d_)) <= (2e-3 + rel) * float(
            torch.linalg.vector_norm(r.grad))

    n0 = (plane_sweep_sample.launches, plane_sweep_variance.launches)
    with torch.no_grad():
        got = plane_sweep_variance(feas[0], feas[1:], projs[0], projs[1:], dv)
    assert (plane_sweep_sample.launches, plane_sweep_variance.launches) == (n0[0] + views, n0[1])
    want = variance_cost_volume(feas[0].float(), [f.float() for f in feas[1:]], projs[0],
                                projs[1:], dv)
    assert got.dtype == dtype
    assert bool(((got.float() - want).abs() <= 1e-4 + rel * want.abs()).all())


@pytest.mark.parametrize("d", [8, 32, 48, 64])
@pytest.mark.parametrize("per_pixel", [False, True])
def test_probstats_bf16_cost_any_depth_count(dev, d, per_pixel):
    """K2 on a bf16 cost (converted exactly in the kernel) against the plain
    version on its fp32 upcast: the templated D (8, 32, 64) and the general
    loop (48), W = 37 filling no block of 32 pixels, and a pixel whose cost
    holds a NaN, which makes all its outputs NaN in both."""
    g = torch.Generator().manual_seed(d)
    b, h, w = 2, 5, 37
    cost = (3 * torch.randn(b, d, h, w, generator=g)).bfloat16()
    cost[1, d // 2, 3, 7] = float("nan")
    if per_pixel:
        dv = (4 + 4 * torch.rand(b, d, h, w, generator=g)).sort(dim=1).values
    else:
        dv = torch.linspace(4, 8, d)[None].repeat(b, 1)
    cost, dv = cost.to(dev), dv.to(dev)
    n0 = probstats.prob_volume_stats_fused.launches
    got = probstats.prob_volume_stats_fused(cost, dv)
    torch.cuda.synchronize()
    assert probstats.prob_volume_stats_fused.launches == n0 + 1
    want = prob_volume_stats(cost.float(), dv)
    assert bool(got["depth"][1, 3, 7].isnan()) and bool(got["prob_volume"][1, :, 3, 7].isnan().all())
    for key, atol in (("prob_volume", 1e-6), ("depth", 1e-5), ("variance", 1e-5)):
        torch.testing.assert_close(got[key], want[key], atol=atol, rtol=0, equal_nan=True)
    gc, wc = got["photometric_confidence"], want["photometric_confidence"]
    assert bool(gc[1, 3, 7].isnan()) and bool(wc[1, 3, 7].isnan())
    flips = (gc - wc).abs() > 1e-5
    assert int(flips.sum()) <= 2


# K5, CostRegNet's Cout=1 prob conv, against F.conv3d of the same weight
# rounded to the input's dtype, computed in fp32 (TF32 off). fp32: both sum
# the 216 products in fp32, in other orders: 1e-5 of the output's largest
# entry. bf16: the kernel sums in fp32 and rounds once (half a bf16 step);
# its fp32 sum differs from the reference's by that reordering, which can
# carry a value across a rounding boundary: one bf16 step of the reference
# plus the fp32 term. Shapes [B, D, H, W]: ragged tiles (B = 2, D = 3,
# 17 x 23; 40 x 70), then the three serving stages at 1152x864.
PROB_SHAPES = [(2, 3, 17, 23), (1, 9, 40, 70), (1, 64, 216, 288), (1, 32, 432, 576),
               (1, 8, 864, 1152)]


def _prob_inputs(dev, dtype, b, d, h, w, layout, seed=0):
    """The volume as the U-Net hands it over (channels_last_3d) or
    contiguous NCDHW, and a seeded Conv3d(8, 1, 3, padding=1, bias=False)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, d, h, w, 8, generator=g, device=dev).to(dtype).permute(0, 4, 1, 2, 3)
    if layout == "contiguous":
        x = x.contiguous()
    m = torch.nn.Conv3d(8, 1, 3, padding=1, bias=False).to(dev)
    with torch.no_grad():
        m.weight.copy_(0.2 * torch.randn(m.weight.shape, generator=g, device=dev))
    return x, m


def _prob_tolerance(want, dtype):
    tol = 1e-5 * want.abs().max()
    if dtype == torch.bfloat16:  # one bf16 step at |want|: 2^(e - 8), want = f 2^e
        tol = tol + torch.ldexp(torch.ones_like(want), torch.frexp(want).exponent - 8)
    return tol


@pytest.mark.parametrize("shape", PROB_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("layout", ["channels_last", "contiguous"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prob_conv_matches_conv(dev, shape, layout, dtype):
    x, m = _prob_inputs(dev, dtype, *shape, layout)
    n0 = prob_conv.prob_conv3d.launches
    with torch.inference_mode():
        got = prob_conv.prob_conv3d(x, m.weight)
        torch.cuda.synchronize()
        want = F.conv3d(x.float(), m.weight.to(dtype).float(), padding=1)
    assert prob_conv.prob_conv3d.launches == n0 + 1
    assert got.dtype == dtype and got.shape == (shape[0], 1, *shape[1:]) and got.is_contiguous()
    assert bool(((got.float() - want).abs() <= _prob_tolerance(want, dtype)).all())


def test_prob_conv_rejects_bad_input(dev):
    x, m = _prob_inputs(dev, torch.float32, 1, 4, 8, 8, "channels_last")
    w = m.weight
    with torch.inference_mode():
        with pytest.raises(ValueError):  # float16
            prob_conv.prob_conv3d(x.half(), w)
        with pytest.raises(ValueError):  # C = 4
            prob_conv.prob_conv3d(x[:, :4], w[:, :4])
        with pytest.raises(ValueError):  # the weight on the CPU
            prob_conv.prob_conv3d(x, w.cpu())
        with pytest.raises(ValueError):  # two output channels
            prob_conv.prob_conv3d(x, torch.cat([w, w]))
        with pytest.raises(ValueError):  # a float16 weight
            prob_conv.prob_conv3d(x, w.half())
    with pytest.raises(RuntimeError, match="no backward"):
        prob_conv.prob_conv3d(x, w)  # the weight needs a gradient


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_costregnet_prob_on_the_kernel(dev, dtype, monkeypatch):
    """CostRegNet in eval under inference_mode: ``prob`` gets the U-Net's
    output in channels_last_3d (read as it is, no copy) and launches the
    kernel once; the output against the plain route (the library
    convolution) at the limits above."""
    seen = []
    kernel = prob_conv.prob_conv3d
    monkeypatch.setattr(costreg, "prob_conv", types.SimpleNamespace(
        CHANNELS=prob_conv.CHANNELS, prob_conv3d=lambda x, w: seen.append(
            x.is_contiguous(memory_format=torch.channels_last_3d)) or kernel(x, w)))
    net = costreg.CostRegNet(8, 8).to(dev).eval()
    x, _ = _prob_inputs(dev, dtype, 2, 16, 24, 40, "channels_last")
    n0 = kernel.launches
    with torch.inference_mode():
        got = net(x)
        want = net(x, plain=True)
    assert seen == [True] and kernel.launches == n0 + 1
    assert got.dtype == dtype and got.shape == (2, 1, 16, 24, 40)
    assert bool(((got.float() - want.float()).abs()
                 <= _prob_tolerance(want.float(), dtype)).all())


@pytest.mark.parametrize("base", [4, 16])
def test_costregnet_prob_other_widths(dev, base):
    """A U-Net of another width (``cr_base_chs`` (8, 4, 16) or (4, 8, 4))
    serves on the card: ``prob`` keeps the library convolution there, as
    its plain route does, and launches no kernel."""
    net = costreg.CostRegNet(8, base).to(dev).eval()
    x, _ = _prob_inputs(dev, torch.bfloat16, 2, 16, 24, 40, "channels_last")
    n0 = prob_conv.prob_conv3d.launches
    with torch.inference_mode():
        got = net(x)
        want = net(x, plain=True)
    assert prob_conv.prob_conv3d.launches == n0
    assert got.shape == (2, 1, 16, 24, 40) and torch.equal(got, want)


def test_cascade_cr_base_chs_serves(dev, monkeypatch):
    """The cascade at ``cr_base_chs`` (8, 4, 16) through DepthRunner on
    the card: stage 1's ``prob`` (8 channels) launches the kernel once a
    request, stages 2 and 3 keep the library convolution; the depths
    against the same model with every ``prob`` on the library convolution
    (fp32, TF32 off), at 1e-4 of the sweep's range (only stage 1's sums
    are ordered otherwise)."""
    from damvsnet_tpu_torch.data.synthetic import make_synthetic_sample
    from damvsnet_tpu_torch.infer import DepthRunner
    from damvsnet_tpu_torch.model import CascadeMVSNet
    sample = make_synthetic_sample(height=64, width=96, nviews=3, ndepths=16, seed=3)
    batch = {"imgs": sample["imgs"][None],
             "proj_matrices": {k: v[None] for k, v in sample["proj_matrices"].items()},
             "depth_values": sample["depth_values"][None]}
    torch.manual_seed(0)
    runner = DepthRunner(CascadeMVSNet(ndepths=(16, 8, 8), cr_base_chs=(8, 4, 16), device=dev),
                         device=dev)
    n0 = prob_conv.prob_conv3d.launches
    got = runner(batch)
    assert prob_conv.prob_conv3d.launches == n0 + 1
    monkeypatch.setattr(costreg, "prob_conv", types.SimpleNamespace(
        CHANNELS=prob_conv.CHANNELS,
        prob_conv3d=lambda x, w: F.conv3d(x, w.to(x.dtype), padding=1)))
    want = runner(batch)
    assert prob_conv.prob_conv3d.launches == n0 + 1
    scale = float(sample["depth_values"].max() - sample["depth_values"].min())
    for key in ("stage1", "stage2"):
        torch.testing.assert_close(got[key]["depth"], want[key]["depth"], rtol=0,
                                   atol=1e-4 * scale)
    torch.testing.assert_close(got["depth"], want["depth"], rtol=0, atol=1e-4 * scale)


# ---- K6, FMT's linear attention (ops/kernels/linear_attention.py) ----
#
# Against the attention computed in fp64 from the same inputs (bf16 inputs
# are exact in fp64), at chip_smoke.py's K6_TOL: the kernel's fp32 sums over
# the tokens are ordered otherwise than any other route, so its error is held
# relative to the same attention of |v| (the sums' absolute size over the
# normaliser); bf16 adds one bf16 step of the reference (the kernel rounds
# once; the fp32 error can cross a rounding boundary).
_TOKENS = 216 * 288  # stage 1 of a 1152x864 view: 62,208


def _attention_inputs(dev, dtype, bq, bk, lq, s, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(bq, lq, 8, 4, generator=g, device=dev).to(dtype)
    k, v = (torch.randn(bk, s, 8, 4, generator=g, device=dev).to(dtype) for _ in range(2))
    return q, k, v


def _assert_attention_close(got, q, k, v):
    from chip_smoke import K6_TOL, attention_fp64
    want = attention_fp64(q, k, v)
    tol = K6_TOL * attention_fp64(q, k, v.abs()).abs()
    if got.dtype == torch.bfloat16:  # one bf16 step at |want|: 2^(e - 8), want = f 2^e
        tol = tol + torch.ldexp(torch.ones_like(want), torch.frexp(want).exponent - 8)
    err = (got.double() - want).abs()
    assert bool((err <= tol).all()), (f"max |err| {float(err.max())}, "
                                      f"{float((err / tol).max())} x its limit")


@pytest.mark.parametrize("batches", [(1, 1), (4, 4), (4, 1)], ids=lambda b: "q%dk%d" % b)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_linear_attention_matches_fp64(dev, batches, dtype):
    """fmt_serve's three shapes: the reference's self layers (1, 1), the
    sources' self layers (4, 4) and their cross layers (4, 1)."""
    q, k, v = _attention_inputs(dev, dtype, batches[0], batches[1], _TOKENS, _TOKENS)
    n0 = la.fused_linear_attention.launches
    with torch.inference_mode():
        got = la.fused_linear_attention(q, k, v)
        torch.cuda.synchronize()
    assert la.fused_linear_attention.launches == n0 + 1
    assert got.dtype == dtype and got.shape == q.shape and got.is_contiguous()
    _assert_attention_close(got, q, k, v)


@pytest.mark.parametrize("tokens", [(1001, 777), (37, 5), (64, 4096 + 33)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_linear_attention_ragged_tokens(dev, tokens, dtype):
    """Token counts that are no multiple of a pass (32 tokens) nor of a
    chunk, queries and keys of other lengths, 2 queries a key batch
    entry."""
    q, k, v = _attention_inputs(dev, dtype, 4, 2, *tokens, seed=1)
    with torch.inference_mode():
        got = la.fused_linear_attention(q, k, v)
    _assert_attention_close(got, q, k, v)


def test_linear_attention_repeats(dev):
    """No atomics: two calls give the same bits."""
    q, k, v = _attention_inputs(dev, torch.bfloat16, 4, 1, _TOKENS, _TOKENS, seed=2)
    with torch.inference_mode():
        a = la.fused_linear_attention(q, k, v)
        b = la.fused_linear_attention(q, k, v)
    assert torch.equal(a, b)


def test_linear_attention_rejects_bad_input(dev):
    q, k, v = _attention_inputs(dev, torch.float32, 4, 2, 64, 64)
    with torch.inference_mode():
        with pytest.raises(ValueError):  # not contiguous
            la.fused_linear_attention(q.transpose(0, 1).contiguous().transpose(0, 1), k, v)
        with pytest.raises(ValueError):  # 4 bytes past 16-byte alignment
            shifted = torch.empty(q.numel() + 1, device=dev)[1:].view(q.shape)
            la.fused_linear_attention(shifted.copy_(q), k, v)
        with pytest.raises(ValueError):  # k on the CPU
            la.fused_linear_attention(q, k.cpu(), v)
    with pytest.raises(RuntimeError, match="no backward"):
        la.fused_linear_attention(q, k.requires_grad_(), v)


def _fmt_features(dev, h=24, w=32, views=5, seed=3):
    """{stage: [1, views, H, W, C]} in bf16 at the FPN's widths."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return {f"stage{s + 1}": torch.randn(1, views, h << s, w << s, 32 >> s, generator=g,
                                         device=dev).bfloat16() for s in range(3)}


def test_fmt_pathway_on_the_kernel(dev):
    """The FMT pathway in bf16 under no_grad: 12 launches a forward (the
    reference's 4 self layers, the sources' 4 self and 4 cross layers),
    every stage against the plain chain at the bf16 tolerance of
    tests/test_torch_fmt.py::test_fmt_pathway_bf16_rounds_where_jax_does;
    under autograd none."""
    from damvsnet_tpu_torch.nn.fmt import FMTWithPathway
    torch.manual_seed(0)
    port = FMTWithPathway(8).to(dev).eval()
    feats = _fmt_features(dev)
    n0 = la.fused_linear_attention.launches
    with torch.no_grad():
        got = port(feats, torch.bfloat16)
        assert la.fused_linear_attention.launches == n0 + 12
        want = port(feats, torch.bfloat16, plain=True)
    assert la.fused_linear_attention.launches == n0 + 12
    for s in got:
        assert got[s].dtype == torch.float32
        torch.testing.assert_close(got[s], want[s], rtol=0, atol=0.05)
    port(feats, torch.bfloat16)  # the weights need a gradient: the plain chain
    assert la.fused_linear_attention.launches == n0 + 12
