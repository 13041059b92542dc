"""The port's variance-aggregation serving cascade against JAX
``CascadeMVSNet(agg_mode="variance")`` on the same weights (through the
bridge) and the same inputs, in fp32 on the CPU, with geo fusion on and off.

JAX runs its banded Pallas sampler (K4) in interpret mode with windows that
cover the rig (overflow 0), clamp_samples on, at ndepths (8, 8, 8), B=1,
N=3, 32x32; the port runs K4's plain version (the wrapper on CPU tensors).
Depth, confidence, the 3-sigma band, the probability volume and the
hypotheses agree per stage to 1e-4, the cascade tolerance of
tests/test_fused_costvol.py. The hypotheses stay in front of every camera,
so JAX's and the port's rules for non-finite coordinates never differ.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from damvsnet_tpu.model import CascadeMVSNet as JCascade
from damvsnet_tpu_torch.infer import DepthRunner
from damvsnet_tpu_torch.model import CascadeMVSNet
from damvsnet_tpu_torch.ops.kernels import COUNTED
from damvsnet_tpu_torch.utils.weights import state_dict_from_flax
from torch_helpers import cascade_batch, perturbed_flat, unflat

torch.set_num_threads(1)

NDEPTHS = (8, 8, 8)
STAGES = ("stage1", "stage2", "stage3")
KEYS = ("depth", "photometric_confidence", "variance", "prob_volume", "depth_values")
PALLAS = {"interpret": True, "wb": 64, "band_rows": 64}


@pytest.fixture(scope="module", params=[True, False], ids=["geo", "nogeo"])
def both(request):
    """JAX outputs (run once, jitted) and the port model on the same
    weights, for one geo-fusion setting."""
    geo = request.param
    batch = cascade_batch(0)
    jargs = (jnp.asarray(batch["imgs"]),
             {k: jnp.asarray(v) for k, v in batch["proj_matrices"].items()},
             jnp.asarray(batch["depth_values"]))
    kw = dict(ndepths=NDEPTHS, cr_base_chs=(8, 8, 8), agg_mode="variance",
              use_geo_fusion=geo, clamp_samples=True)
    # the sampler holds no parameters: init on the XLA gather (quicker to trace)
    variables = jax.jit(JCascade(sampler="xla", **kw).init, static_argnames=("train",))(
        jax.random.PRNGKey(0), *jargs, train=False)
    flat = perturbed_flat(variables)
    want = jax.jit(JCascade(sampler="pallas", sampler_opts=PALLAS, **kw).apply,
                   static_argnames=("train",))(unflat(flat), *jargs, train=False)
    assert int(want["sampler_overflow"]) == 0
    want = {s: {k: np.asarray(want[s][k]) for k in KEYS} for s in STAGES}
    port = CascadeMVSNet(ndepths=NDEPTHS, device="cpu", agg_mode="variance",
                         use_geo_fusion=geo)
    port.load_state_dict(state_dict_from_flax(flat, "variance", geo), strict=True)
    return batch, want, port


@pytest.mark.parametrize("stage", STAGES)
def test_variance_cascade_matches_jax(both, stage):
    batch, want, port = both
    with torch.inference_mode():
        got = port(torch.from_numpy(batch["imgs"]),
                   {k: torch.from_numpy(v) for k, v in batch["proj_matrices"].items()},
                   torch.from_numpy(batch["depth_values"]))
    for key in KEYS:
        np.testing.assert_allclose(got[stage][key].numpy(), want[stage][key],
                                   atol=1e-4, err_msg=f"{stage}/{key}")


def test_depth_runner_serves_variance(both):
    """DepthRunner serves the variance model unchanged; on CPU tensors no
    kernel is launched."""
    batch, want, port = both
    counts = [fn.launches for fn in COUNTED]
    out = DepthRunner(port, device="cpu")(batch)
    assert counts == [fn.launches for fn in COUNTED]
    np.testing.assert_allclose(out["depth"], want["stage3"]["depth"], atol=1e-4)
    np.testing.assert_allclose(out["stage2"]["photometric_confidence"],
                               want["stage2"]["photometric_confidence"], atol=1e-4)


def test_variance_configuration_modules():
    """No weight net in variance mode, no geo fusion without it, U-Net
    widths from cr_base_chs; align_corners kept in either aggregation."""
    model = CascadeMVSNet(ndepths=NDEPTHS, device="cpu", agg_mode="variance",
                          use_geo_fusion=False, cr_base_chs=(8, 4, 16))
    names = {k.split(".")[0] for k in model.state_dict()}
    assert names == {"feature", "cost_regularization"}
    assert [r.conv0.conv.out_channels for r in model.cost_regularization] == [8, 4, 16]
    assert CascadeMVSNet(device="cpu", agg_mode="variance", align_corners=True).align_corners
    adaptive = CascadeMVSNet(device="cpu", align_corners=True)
    assert adaptive.agg_mode == "adaptive" and adaptive.align_corners
