"""Kernel K1 (fused adaptive cost volume): the port's plain version and its
wrapper on CPU tensors against the JAX Pallas kernel (interpret mode) and
the JAX XLA path, on the same numpy inputs and the same weight net. The
variance cost volume, over the plain warp and over the K4 sampler wrapper,
and K4's variance entry ``plane_sweep_variance`` on CPU tensors (its plain
version), against JAX's variance mode on its Pallas sampler (interpret
mode).

Tolerance 5e-5, as tests/test_fused_costvol.py holds the Pallas kernel to
the XLA path: the three implementations order the geometry and the sums
differently in fp32. The Pallas kernel needs 128 % C == 0 and H % 8 == 0.
"""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from damvsnet_tpu.nn.aggweight import AggWeightNetVolume as JAggWeight
from damvsnet_tpu.nn.aggweight import fold_aggweight as jfold
from damvsnet_tpu.ops.costvol import build_cost_volume as jbuild
from damvsnet_tpu.ops.pallas.fused_costvol import fused_adaptive_cost_volume as jfused
from damvsnet_tpu_torch.nn.aggweight import AggWeightNetVolume, fold_aggweight
from damvsnet_tpu_torch.ops.costvol import build_cost_volume, variance_cost_volume
from damvsnet_tpu_torch.ops.kernels import fused_costvol
from damvsnet_tpu_torch.ops.kernels.sweep_sampler import plane_sweep_sample, plane_sweep_variance
from damvsnet_tpu_torch.ops.warp import plane_sweep_warp
from torch_helpers import flax_two_pass_variance, fused_projs

torch.set_num_threads(1)

B, H, W, C, D, V = 1, 24, 32, 8, 4, 3


@pytest.fixture(scope="module")
def wnets():
    """The JAX weight net with non-trivial BN statistics, and the port's
    net holding the same weights."""
    rs = np.random.default_rng(1)
    net = JAggWeight()
    variables = net.init(jax.random.PRNGKey(1), jnp.zeros((1, 1, 1, 1, C)), False)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = {blk: {"_NormAct_0": {"BatchNorm_0": {
        "mean": rs.normal(0, 0.3, 1).astype(np.float32),
        "var": rs.uniform(0.5, 2.0, 1).astype(np.float32)}}}
        for blk in ("Conv3dBlock_0", "Conv3dBlock_1")}
    for blk in stats:
        bn = params[blk]["_NormAct_0"]["BatchNorm_0"]
        bn["scale"] = rs.uniform(0.5, 1.5, 1).astype(np.float32)
        bn["bias"] = rs.normal(0, 0.3, 1).astype(np.float32)
    jvars = {"params": params, "batch_stats": stats}

    port = AggWeightNetVolume(C).eval()
    with torch.no_grad():
        for j, blk in enumerate(("Conv3dBlock_0", "Conv3dBlock_1")):
            tb = port.w_net[j]
            k = params[blk]["Conv_0"]["kernel"]  # [1,1,1,I,O]
            tb.conv.weight.copy_(torch.from_numpy(k.transpose(4, 3, 0, 1, 2).copy()))
            bn = params[blk]["_NormAct_0"]["BatchNorm_0"]
            st = stats[blk]["_NormAct_0"]["BatchNorm_0"]
            tb.bn.weight.copy_(torch.from_numpy(bn["scale"]))
            tb.bn.bias.copy_(torch.from_numpy(bn["bias"]))
            tb.bn.running_mean.copy_(torch.from_numpy(st["mean"]))
            tb.bn.running_var.copy_(torch.from_numpy(st["var"]))
    return net, jvars, port


def test_fold_aggweight_matches_module(rng, wnets):
    """The port's fold equals its module, and JAX's fold."""
    _, jvars, port = wnets
    x = rng.random((2, 3, 4, 5, C)).astype(np.float32)
    with torch.no_grad():
        want = port(torch.from_numpy(x))
    w1, b1, w2, b2 = fold_aggweight(port)
    got = fused_costvol.folded_weight_fn(w1, b1, w2, b2)(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(), atol=1e-5)
    for a, b in zip((w1, b1, w2, b2), jfold(jvars)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-6)


# (per-pixel hypotheses, align_corners); the ids of the first two cases
# predate the align_corners axis
@pytest.mark.parametrize("per_pixel, align_corners",
                         [(False, False), (True, False), (False, True), (True, True)],
                         ids=["False", "True", "False-align_corners", "True-align_corners"])
def test_plain_and_wrapper_match_jax(rng, wnets, per_pixel, align_corners):
    net, jvars, port = wnets
    projs = fused_projs(B, V + 1, H, W)
    feas = [rng.standard_normal((B, H, W, C)).astype(np.float32)
            for _ in range(V + 1)]
    if per_pixel:
        dv = (4 + 4 * rng.random((B, D, H, W))).astype(np.float32)
    else:
        dv = np.linspace(4, 8, D, dtype=np.float32)[None]

    jw = lambda vol: net.apply(jvars, vol, False)
    want_xla = np.asarray(jbuild(
        jnp.asarray(feas[0]), [jnp.asarray(f) for f in feas[1:]],
        jnp.asarray(projs[0]), [jnp.asarray(p) for p in projs[1:]],
        jnp.asarray(dv), mode="adaptive", weight_fn=jw, align_corners=align_corners,
        sampler="xla"))
    want_pallas, overflow = jfused(
        jnp.asarray(feas[0]), [jnp.asarray(f) for f in feas[1:]],
        jnp.asarray(projs[0]), [jnp.asarray(p) for p in projs[1:]],
        jnp.asarray(dv), *jfold(jvars), align_corners=align_corners, wb=W, band_rows=H,
        interpret=True)
    assert int(np.asarray(overflow).sum()) == 0

    t = [torch.from_numpy(f) for f in feas]
    tp = [torch.from_numpy(p) for p in projs]
    w1, b1, w2, b2 = fold_aggweight(port)
    launches = fused_costvol.fused_adaptive_cost_volume.launches
    with torch.no_grad():
        got_wrapper = fused_costvol.fused_adaptive_cost_volume(
            t[0], t[1:], tp[0], tp[1:], torch.from_numpy(dv), w1, b1, w2, b2,
            align_corners)
        # the plain version with the unfolded module as its weight net
        got_module = build_cost_volume(t[0], t[1:], tp[0], tp[1:],
                                       torch.from_numpy(dv), port, align_corners)
    assert fused_costvol.fused_adaptive_cost_volume.launches == launches
    assert got_wrapper.shape == (B, D, H, W, C)
    for got in (got_wrapper.numpy(), got_module.numpy()):
        np.testing.assert_allclose(got, want_xla, atol=5e-5)
        np.testing.assert_allclose(got, np.asarray(want_pallas), atol=5e-5)


def test_wrapper_keeps_feature_dtype(rng, wnets):
    """bf16 features give a bf16 volume, summed in fp32 (the kernel's
    contract): it equals the fp32 sum of the bf16-rounded inputs, rounded
    once."""
    _, _, port = wnets
    projs = [torch.from_numpy(p) for p in fused_projs(B, V + 1, H, W)]
    feas = [torch.from_numpy(rng.standard_normal((B, H, W, C)).astype(np.float32))
            .to(torch.bfloat16) for _ in range(V + 1)]
    dv = torch.linspace(4, 8, D)[None]
    w = fold_aggweight(port)
    with torch.no_grad():
        got = fused_costvol.fused_adaptive_cost_volume(
            feas[0], feas[1:], projs[0], projs[1:], dv, *w)
        ref = fused_costvol.fused_adaptive_cost_volume(
            feas[0].float(), [f.float() for f in feas[1:]], projs[0], projs[1:],
            dv, *w)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  ref.to(torch.bfloat16).float().numpy())


@pytest.mark.parametrize("mode", ["adaptive", "variance"])
def test_training_volume_matches_jax(rng, wnets, mode):
    """The non-fused training step's cost volume under autograd, against
    JAX's XLA path in training (flax's batch variance two-pass): adaptive,
    ``build_cost_volume`` with the weight net's live form (batch-statistics
    BN, its running statistics updated once per source view, chained as
    flax chains them), and variance. The volume and the updated statistics
    at 5e-5, and the gradients of sum(volume * cot) with respect to the
    features and the weight net's parameters within 1e-4 of the largest JAX
    entry of each (a weight-net block's, for its BN-normalized tensors; see
    tests/test_torch_train_step_nonfused.py)."""
    net, jvars, port = wnets
    projs = fused_projs(B, V + 1, H, W)
    feas = [rng.standard_normal((B, H, W, C)).astype(np.float32) for _ in range(V + 1)]
    dv = (4 + 4 * rng.random((B, D, H, W))).astype(np.float32)
    cot = rng.standard_normal((B, D, H, W, C)).astype(np.float32)

    def jvolume(feas, params):
        stats = jvars["batch_stats"]

        def weight_fn(vol):
            nonlocal stats
            w, mutated = net.apply({"params": params, "batch_stats": stats}, vol, True,
                                   mutable=["batch_stats"])
            stats = mutated["batch_stats"]
            return w

        vol = jbuild(feas[0], feas[1:], jnp.asarray(projs[0]),
                     [jnp.asarray(p) for p in projs[1:]], jnp.asarray(dv), mode=mode,
                     weight_fn=weight_fn if mode == "adaptive" else None, sampler="xla")
        return jnp.sum(vol * cot), (vol, stats)

    with flax_two_pass_variance():
        (_, (want, jstats)), (jdfeas, jdparams) = jax.value_and_grad(
            jvolume, argnums=(0, 1), has_aux=True)([jnp.asarray(f) for f in feas],
                                                   jvars["params"])

    live = copy.deepcopy(port).train()
    t = [torch.from_numpy(f).requires_grad_() for f in feas]
    tp = [torch.from_numpy(p) for p in projs]
    if mode == "adaptive":
        got = build_cost_volume(t[0], t[1:], tp[0], tp[1:], torch.from_numpy(dv), live)
    else:
        got = variance_cost_volume(t[0], t[1:], tp[0], tp[1:], torch.from_numpy(dv))
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=5e-5)
    pairs = [(f"dfea{v}", t[v].grad, jdfeas[v]) for v in range(V + 1)]
    if mode == "adaptive":
        for j, blk in enumerate(("Conv3dBlock_0", "Conv3dBlock_1")):
            tb = live.w_net[j]
            jst = jstats[blk]["_NormAct_0"]["BatchNorm_0"]
            np.testing.assert_allclose(tb.bn.running_mean.numpy(), np.asarray(jst["mean"]),
                                       atol=5e-5, err_msg=blk)
            np.testing.assert_allclose(tb.bn.running_var.numpy(), np.asarray(jst["var"]),
                                       rtol=5e-5, err_msg=blk)
            jp = jdparams[blk]
            kernel = np.asarray(jp["Conv_0"]["kernel"]).transpose(4, 3, 0, 1, 2)
            scale = max(np.abs(np.asarray(a)).max() for a in jax.tree_util.tree_leaves(jp))
            block = [(f"{blk}/conv", tb.conv.weight.grad, kernel),
                     (f"{blk}/bn.weight", tb.bn.weight.grad,
                      jp["_NormAct_0"]["BatchNorm_0"]["scale"]),
                     (f"{blk}/bn.bias", tb.bn.bias.grad, jp["_NormAct_0"]["BatchNorm_0"]["bias"])]
            for name, g, jg in block:
                np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-4 * scale,
                                           err_msg=name)
    for name, g, jg in pairs:
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, atol=1e-4 * np.abs(jg).max(), err_msg=name)


def _jax_variance(rng, per_pixel, align_corners):
    """Seeded inputs as torch tensors (features, projections, depths) and
    JAX's variance cost volume of them on its interpret-mode Pallas sampler."""
    projs = fused_projs(B, V + 1, H, W)
    feas = [rng.standard_normal((B, H, W, C)).astype(np.float32)
            for _ in range(V + 1)]
    if per_pixel:
        dv = (4 + 4 * rng.random((B, D, H, W))).astype(np.float32)
    else:
        dv = np.linspace(4, 8, D, dtype=np.float32)[None]
    want, overflow = jbuild(
        jnp.asarray(feas[0]), [jnp.asarray(f) for f in feas[1:]],
        jnp.asarray(projs[0]), [jnp.asarray(p) for p in projs[1:]],
        jnp.asarray(dv), mode="variance", align_corners=align_corners,
        sampler="pallas", sampler_opts={"interpret": True, "wb": W, "band_rows": H},
        return_overflow=True)
    assert int(np.asarray(overflow).sum()) == 0
    return ([torch.from_numpy(f) for f in feas], [torch.from_numpy(p) for p in projs],
            torch.from_numpy(dv), np.asarray(want))


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("per_pixel", [False, True])
def test_variance_matches_jax(rng, per_pixel, align_corners):
    t, tp, dv, want = _jax_variance(rng, per_pixel, align_corners)
    for warp in (plane_sweep_warp, plane_sweep_sample):
        got = variance_cost_volume(t[0], t[1:], tp[0], tp[1:], dv,
                                   warp=warp, align_corners=align_corners)
        assert got.shape == (B, D, H, W, C) and got.is_contiguous()
        np.testing.assert_allclose(got.numpy(), want, atol=5e-5, err_msg=warp.__name__)


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("per_pixel", [False, True])
def test_variance_entry_matches_jax(rng, per_pixel, align_corners):
    """K4's variance entry on CPU tensors (its plain version) against JAX's
    variance cost volume; no kernel launches."""
    t, tp, dv, want = _jax_variance(rng, per_pixel, align_corners)
    launches = (plane_sweep_variance.launches, plane_sweep_sample.launches)
    got = plane_sweep_variance(t[0], t[1:], tp[0], tp[1:], dv, align_corners)
    assert (plane_sweep_variance.launches, plane_sweep_sample.launches) == launches
    assert got.dtype == torch.float32 and got.shape == (B, D, H, W, C) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5)


def test_variance_keeps_feature_dtype(rng):
    """bf16 features give a bf16 variance volume, summed in fp32 and
    rounded once."""
    projs = [torch.from_numpy(p) for p in fused_projs(B, V + 1, H, W)]
    feas = [torch.from_numpy(rng.standard_normal((B, H, W, C)).astype(np.float32))
            .to(torch.bfloat16) for _ in range(V + 1)]
    dv = torch.linspace(4, 8, D)[None]
    got = variance_cost_volume(feas[0], feas[1:], projs[0], projs[1:], dv)
    ref = variance_cost_volume(feas[0].float(), [f.float() for f in feas[1:]], projs[0],
                               projs[1:], dv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  ref.to(torch.bfloat16).float().numpy())
    # the sampler's bf16 warp is summed as it is, as if cast to fp32 first
    got = variance_cost_volume(feas[0], feas[1:], projs[0], projs[1:], dv,
                               warp=plane_sweep_sample)
    ref = variance_cost_volume(feas[0], feas[1:], projs[0], projs[1:], dv,
                               warp=lambda *a: plane_sweep_sample(*a).float())
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), ref.float().numpy())
    # K4's variance entry sums the unrounded fp32 samples, rounded once
    got = plane_sweep_variance(feas[0], feas[1:], projs[0], projs[1:], dv)
    ref = variance_cost_volume(feas[0].float(), [f.float() for f in feas[1:]], projs[0],
                               projs[1:], dv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  ref.to(torch.bfloat16).float().numpy())
