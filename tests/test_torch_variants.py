"""The port's model variants against the JAX package's, in fp32 on the CPU:
the library modules (GeoRegNet2d with its std and z encodings, RefineNet,
the U-Net FeatureNet, Reg2d, Hourglass3d, AggWeightNetVolume2) and the
cascade with ``reg_mode="georeg"``, ``refine`` and ``arch_mode="unet"``;
and ``share_cr``, which neither package builds.

Each module gets the port module's seeded init, its BN running statistics
moved off (0, 1), as flax variables through the bridge's table read
backwards, and back through ``utils.weights.module_state_dict_from_flax``
(a mapping that the JAX module does not take fails its apply); the same
seeded numpy inputs go through both. The outputs are held at 5e-5 of their largest
entry (the cost volume's tolerance, tests/test_fused_costvol.py:75, scaled:
the deep stacks' outputs reach tens), in eval mode and in train mode
(batch statistics; flax's batch variance two-pass, as the port's), where
every running statistic must also move and match at 1e-5. The cascade is
held as tests/test_torch_cascade.py holds the serving cascade: per stage,
depth, confidence, the 3-sigma band, the probability volume and the
hypotheses at 1e-4, and the refined depth.
"""
import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from damvsnet_tpu.model import CascadeMVSNet as JCascade
from damvsnet_tpu.nn.aggweight import AggWeightNetVolume2 as JAggWeight2
from damvsnet_tpu.nn.blocks import Hourglass3d as JHourglass
from damvsnet_tpu.nn.costreg import Reg2d as JReg2d
from damvsnet_tpu.nn.feature import FeatureNet as JFeatureNet
from damvsnet_tpu.nn.georeg import GeoRegNet2d as JGeoReg
from damvsnet_tpu.nn.precision import compute_dtype as jax_compute_dtype
from damvsnet_tpu.ops.resize import resize_bilinear as jresize_bilinear
from damvsnet_tpu.nn.refine import RefineNet as JRefine
from damvsnet_tpu_torch.model import CascadeMVSNet
from damvsnet_tpu_torch.nn.aggweight import AggWeightNetVolume2
from damvsnet_tpu_torch.nn.blocks import Hourglass3d
from damvsnet_tpu_torch.nn.costreg import Reg2d
from damvsnet_tpu_torch.nn.feature import FeatureNet
from damvsnet_tpu_torch.nn.georeg import GeoRegNet2d
from damvsnet_tpu_torch.nn.refine import RefineNet
from damvsnet_tpu_torch.ops.resize import resize_bilinear
from damvsnet_tpu_torch.utils.weights import _table as weight_table
from damvsnet_tpu_torch.utils.weights import (module_state_dict_from_flax, module_table,
                                              state_dict_from_flax)
from torch_helpers import cascade_batch, flax_two_pass_variance, port_flax_flat, unflat

torch.set_num_threads(1)

MODULE_TOL = 5e-5
STATS_TOL = 1e-5
STAGES = ("stage1", "stage2", "stage3")
MODES = ("eval", "train")


def _flat(tree, coll):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {coll + "/" + "/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
            for kp, v in leaves}


def _ncdhw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 4, 1, 2, 3)))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _close(got, want, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _close(got[k], want[k], f"{what}/{k}")
        return
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=MODULE_TOL * max(1.0, float(np.abs(want).max())),
                               err_msg=what)


def _jitted(fn, first, jargs):
    """fn(first, *jargs) under jax.jit, the non-array arguments (a stage
    index, None) static: an eager flax module compiles every op alone."""
    idx = [i for i, a in enumerate(jargs) if isinstance(a, jax.Array)]

    def call(first, *arrays):
        args = list(jargs)
        for i, a in zip(idx, arrays):
            args[i] = a
        return fn(first, *args)
    return jax.jit(call)(first, *[jargs[i] for i in idx])


def _held(mode, jmod, jargs, port, port_args, to_np, kind, jkw=None, table_kw=None):
    """The port module's seeded init carried into the JAX module's variables
    (and back through ``module_state_dict_from_flax``), then both in
    ``mode``: the outputs (the port's through ``to_np`` into JAX's layout)
    and, in train mode, every running statistic, each of which must move."""
    jkw, table_kw = jkw or {}, table_kw or {}
    torch.manual_seed(0)
    flat = port_flax_flat(port, module_table(kind, **table_kw))
    port.load_state_dict(module_state_dict_from_flax(flat, kind, **table_kw), strict=True)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    train = mode == "train"
    port.train(train)
    with torch.no_grad(), torch.backends.mkldnn.flags(enabled=False):
        got = to_np(port(*port_args))
    if not train:
        _close(got, _jitted(lambda v, *a: jmod.apply(v, *a, **jkw), unflat(flat), jargs),
               f"{kind} eval")
        return
    with flax_two_pass_variance():
        want, mutated = _jitted(lambda v, *a: jmod.apply(v, *a, **jkw, train=True,
                                                         mutable=["batch_stats"]),
                                unflat(flat), jargs)
    _close(got, want, f"{kind} train")
    params = {k: v for k, v in flat.items() if k.startswith("params/")}
    want_sd = module_state_dict_from_flax({**params, **_flat(mutated["batch_stats"],
                                                             "batch_stats")},
                                          kind, **table_kw)
    sd = port.state_dict()
    names = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert names
    for name in names:
        assert not torch.equal(sd[name], before[name]), f"{name} did not move"
        np.testing.assert_allclose(sd[name].numpy(), want_sd[name].numpy(), rtol=STATS_TOL,
                                   atol=STATS_TOL, err_msg=name)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("stage_idx,encoding", [(0, "std"), (1, "z"), (2, "z")])
def test_georeg(rng, mode, stage_idx, encoding):
    """GeoRegNet2d as the cascade runs it: std at stage 0, z at stages 1 and
    2 on the previous probability volume (D_prev = 2D, then 4D)."""
    b, d, h, w, c = 2, 4, 16, 16, (32, 16, 8)[stage_idx]
    x = rng.standard_normal((b, d, h, w, c)).astype(np.float32)
    pv = None
    if encoding == "z":
        d_prev = d * (2 if stage_idx == 1 else 4)
        logits = rng.standard_normal((b, d_prev, h, w)).astype(np.float32)
        pv = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    jargs = (jnp.asarray(x), stage_idx, None if pv is None else jnp.asarray(pv))
    port_args = (_ncdhw(x), stage_idx, None if pv is None else torch.from_numpy(pv))
    _held(mode, JGeoReg(convolutional_layer_encoding=encoding), jargs,
          GeoRegNet2d(c, encoding), port_args, lambda y: y.numpy(), "georeg")


# bf16: the two packages' convolutions round their bf16 outputs after sums
# in other orders; two bf16 steps (2^-6 relative) of the output's largest
BF16_MODULE_TOL = 2.0 ** -6


@pytest.mark.parametrize("upsample", ["F.interpolate", "resize_bilinear"])
@pytest.mark.parametrize("stage_idx", [1, 2])
def test_georeg_stage_bf16_against_jax(stage_idx, upsample):
    """A GeoReg stage in bf16 as the cascades run it: the previous stage's
    fp32 probability volume upsampled x2 (the port by ``F.interpolate`` as
    model/cascade.py does, or by ops/resize.py's ``resize_bilinear``; JAX by
    its separable resize), then GeoRegNet2d on a bf16 cost volume. The
    upsampled volumes differ by an fp32 ulp on about a third of their
    entries (torch sums the four taps in another order); the bf16 outputs
    are the same for both of the port's upsamples and within two bf16 steps
    of JAX's. Prints the differences."""
    rs = np.random.default_rng(stage_idx)
    d, h, w, c = (8, 4)[stage_idx - 1], 32, 32, (16, 8)[stage_idx - 1]
    d_prev = d * (2 if stage_idx == 1 else 4)
    torch.manual_seed(0)
    port = GeoRegNet2d(c, "z")
    flat = port_flax_flat(port, module_table("georeg"))
    port.load_state_dict(module_state_dict_from_flax(flat, "georeg"), strict=True)
    port.eval()
    x = np.asarray(jnp.asarray(rs.standard_normal((1, d, h, w, c)), jnp.bfloat16), np.float32)
    logits = 3.0 * rs.standard_normal((1, d_prev, h // 2, w // 2))
    pv = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(np.float32)
    want_up = np.moveaxis(np.asarray(jresize_bilinear(jnp.moveaxis(jnp.asarray(pv), 1, -1),
                                                      (h, w))), -1, 1)
    with jax_compute_dtype(jnp.bfloat16):
        want = np.asarray(jax.jit(lambda v, a, p: JGeoReg().apply(v, a, stage_idx, p))(
            unflat(flat), jnp.asarray(x, jnp.bfloat16), jnp.asarray(want_up)), np.float32)
    ups = {"F.interpolate": lambda t: F.interpolate(t, size=(h, w), mode="bilinear",
                                                    align_corners=False),
           "resize_bilinear": lambda t: resize_bilinear(t.permute(0, 2, 3, 1),
                                                        (h, w)).permute(0, 3, 1, 2)}
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 4, 1, 2, 3))).bfloat16()
    got, got_up = {}, {}
    with torch.no_grad():
        for name, up in ups.items():
            got_up[name] = up(torch.from_numpy(pv))
            got[name] = port(xt, stage_idx, got_up[name]).float().numpy()
    up_diff = np.abs(got_up[upsample].numpy() - want_up)
    out_diff = np.abs(got[upsample] - want)
    print("GeoReg stage bf16 vs JAX", json.dumps({
        "stage_idx": stage_idx, "upsample": upsample,
        "upsampled_max_abs": float(up_diff.max()),
        "upsampled_differ_share": float((up_diff > 0).mean()),
        "out_max_abs": float(out_diff.max()), "out_mean_abs": float(out_diff.mean()),
        "out_scale": float(np.abs(want).max())}))
    assert up_diff.max() <= 2.0 ** -23
    np.testing.assert_array_equal(got["F.interpolate"], got["resize_bilinear"])
    np.testing.assert_allclose(got[upsample], want, rtol=0,
                               atol=BF16_MODULE_TOL * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("mode", MODES)
def test_refine(rng, mode):
    img = rng.random((2, 16, 20, 3)).astype(np.float32)
    depth = (4 + 4 * rng.random((2, 16, 20))).astype(np.float32)
    _held(mode, JRefine(), (jnp.asarray(img), jnp.asarray(depth)), RefineNet(),
          (torch.from_numpy(img), torch.from_numpy(depth)), lambda y: y.numpy(), "refine")


@pytest.mark.parametrize("mode", MODES)
def test_unet_feature(rng, mode):
    """The U-Net FeatureNet: its three stages, NHWC on both sides."""
    x = rng.random((2, 32, 40, 3)).astype(np.float32)

    def to_np(out):
        return {k: v.numpy().transpose(0, 2, 3, 1) for k, v in out.items()}

    _held(mode, JFeatureNet(base_channels=8, arch_mode="unet", height_block=0),
          (jnp.asarray(x),), FeatureNet(8, arch_mode="unet"), (_nchw(x),), to_np,
          "feature", table_kw={"arch_mode": "unet"})


@pytest.mark.parametrize("mode", MODES)
def test_reg2d(rng, mode):
    x = rng.standard_normal((2, 4, 16, 16, 16)).astype(np.float32)
    _held(mode, JReg2d(base_channels=8), (jnp.asarray(x),), Reg2d(16, 8), (_ncdhw(x),),
          lambda y: y.numpy(), "reg2d")


@pytest.mark.parametrize("mode", MODES)
def test_hourglass3d(rng, mode):
    x = rng.standard_normal((2, 8, 8, 8, 4)).astype(np.float32)
    _held(mode, JHourglass(channels=4), (jnp.asarray(x),), Hourglass3d(4), (_ncdhw(x),),
          lambda y: y.numpy().transpose(0, 2, 3, 4, 1), "hourglass3d")


@pytest.mark.parametrize("mode", MODES)
def test_aggweight2(rng, mode):
    x = rng.standard_normal((2, 4, 8, 8, 16)).astype(np.float32)
    _held(mode, JAggWeight2(), (jnp.asarray(x),), AggWeightNetVolume2(16),
          (torch.from_numpy(x),), lambda y: y.numpy(), "aggweight2")


# ---- the cascade: GeoRegNet2d, RefineNet and the U-Net FeatureNet ----

NDEPTHS = (16, 8, 2)  # georeg pools D once at stage 2, twice at stage 3
CONFIG = {"reg_mode": "georeg", "refine": True, "arch_mode": "unet"}


@pytest.fixture(scope="module")
def cascades():
    """JAX's outputs (one jitted init and apply) and the port's, on the same
    weights and batch."""
    batch = cascade_batch(0)
    jargs = (jnp.asarray(batch["imgs"]),
             {k: jnp.asarray(v) for k, v in batch["proj_matrices"].items()},
             jnp.asarray(batch["depth_values"]))
    torch.manual_seed(0)
    port = CascadeMVSNet(ndepths=NDEPTHS, device="cpu", **CONFIG)
    flat = port_flax_flat(port, weight_table(**CONFIG))
    port.load_state_dict(state_dict_from_flax(flat, **CONFIG), strict=True)
    jmodel = JCascade(ndepths=NDEPTHS, clamp_samples=True, **CONFIG)
    want = jax.jit(jmodel.apply, static_argnames=("train",))(unflat(flat), *jargs, train=False)
    with torch.inference_mode():
        got = port(torch.from_numpy(batch["imgs"]),
                   {k: torch.from_numpy(v) for k, v in batch["proj_matrices"].items()},
                   torch.from_numpy(batch["depth_values"]))
    return want, got


@pytest.mark.parametrize("stage", STAGES)
def test_georeg_refine_unet_cascade(cascades, stage):
    want, got = cascades
    for key in ("depth", "photometric_confidence", "variance", "prob_volume",
                "depth_values"):
        np.testing.assert_allclose(got[stage][key].numpy(), np.asarray(want[stage][key]),
                                   atol=1e-4, err_msg=f"{stage}/{key}")


def test_refined_depth(cascades):
    want, got = cascades
    assert got["refined_depth"].shape == got["depth"].shape
    np.testing.assert_allclose(got["refined_depth"].numpy(), np.asarray(want["refined_depth"]),
                               atol=1e-4)
    assert not np.allclose(got["refined_depth"].numpy(), got["depth"].numpy())


def test_share_cr_builds_in_neither_package():
    """One CostRegNet cannot take the stages' 32/16/8-channel volumes: JAX's
    shared regularizer fails at init, at stage 2; the port refuses it when
    the model is built."""
    batch = cascade_batch(0)
    jargs = (jnp.asarray(batch["imgs"]),
             {k: jnp.asarray(v) for k, v in batch["proj_matrices"].items()},
             jnp.asarray(batch["depth_values"]))
    jmodel = JCascade(ndepths=(8, 8, 8), share_cr=True, use_geo_fusion=False)
    with pytest.raises(Exception, match="cost_regularization/Conv3dBlock_0") as info:
        jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), *jargs, train=False))
    assert "ScopeParamShapeError" in type(info.value).__name__
    with pytest.raises(ValueError, match="share_cr: one CostRegNet cannot take"):
        CascadeMVSNet(device="cpu", share_cr=True)


@pytest.mark.parametrize("config,match", [
    ({"grad_method": "stop"}, "grad_method"),
    ({"reg_mode": "reg2d"}, "reg_mode"),
    ({"reg_mode": "georeg", "ndepths": (64, 32, 16)}, "ndepths must be"),
    ({"arch_mode": "fpn2"}, "arch_mode"),
])
def test_bad_variant_configuration_raises(config, match):
    with pytest.raises(ValueError, match=match):
        CascadeMVSNet(device="cpu", **config)
