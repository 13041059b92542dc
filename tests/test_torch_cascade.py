"""The port's serving cascade against JAX ``CascadeMVSNet.apply`` on the same
weights (passed through the bridge) and the same inputs, in fp32 on the CPU.

Both run geo fusion and adaptive aggregation at ndepths (8, 8, 8), B=1,
N=3, 32x32, with clamp_samples on (the port's shipped configuration) and
off (the JAX package's default, what its ``cli/test.py
--no_clamp_samples`` serves), and off with the cost volume sampled
align_corners=True (JAX's ``sampler_opts={"align_corners": True}``, the
accuracy chain's model, scripts/e2e_synthetic.py). JAX takes its XLA paths on the CPU;
the port takes its kernels' plain versions (the wrappers on CPU tensors).
Depth, confidence and the 3-sigma band (and the probability volume and
the hypotheses) agree per stage to 1e-4, the tolerance
tests/test_fused_costvol.py holds the fused cascade to.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from damvsnet_tpu.model import CascadeMVSNet as JCascade
from damvsnet_tpu_torch.infer import DepthRunner
from damvsnet_tpu_torch.model import CascadeMVSNet
from damvsnet_tpu_torch.ops.kernels import fused_costvol, probstats
from damvsnet_tpu_torch.utils.weights import state_dict_from_flax
from torch_helpers import cascade_batch as _batch, perturbed_flat, unflat

torch.set_num_threads(1)

B, H, W = 1, 32, 32
NDEPTHS = (8, 8, 8)
STAGES = ("stage1", "stage2", "stage3")


@pytest.fixture(scope="module", params=[(True, False), (False, False), (False, True)],
                ids=["clamp", "noclamp", "noclamp_align_corners"])
def both(request):
    """JAX outputs (run once) and the port model on the same weights, for
    one (clamp_samples, align_corners) setting."""
    clamp, align_corners = request.param
    batch = _batch(0)
    jargs = (jnp.asarray(batch["imgs"]),
             {k: jnp.asarray(v) for k, v in batch["proj_matrices"].items()},
             jnp.asarray(batch["depth_values"]))
    jmodel = JCascade(ndepths=NDEPTHS, cr_base_chs=(8, 8, 8), clamp_samples=clamp,
                      sampler_opts={"align_corners": True} if align_corners else None)
    # jitted: an eager flax init of the cascade takes minutes on the CPU
    variables = jax.jit(jmodel.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), *jargs, train=False)
    flat = perturbed_flat(variables)
    want = jax.jit(jmodel.apply, static_argnames=("train",))(
        unflat(flat), *jargs, train=False)
    want = {s: {k: np.asarray(want[s][k]) for k in
                ("depth", "photometric_confidence", "variance", "prob_volume",
                 "depth_values")} for s in STAGES}
    port = CascadeMVSNet(ndepths=NDEPTHS, device="cpu", clamp_samples=clamp,
                         align_corners=align_corners)
    port.load_state_dict(state_dict_from_flax(flat), strict=True)
    return batch, want, port


@pytest.mark.parametrize("stage", STAGES)
def test_cascade_matches_jax(both, stage):
    batch, want, port = both
    with torch.inference_mode():
        got = port(torch.from_numpy(batch["imgs"]),
                   {k: torch.from_numpy(v) for k, v in batch["proj_matrices"].items()},
                   torch.from_numpy(batch["depth_values"]))
    for key in ("depth", "photometric_confidence", "variance", "prob_volume",
                "depth_values"):
        np.testing.assert_allclose(got[stage][key].numpy(), want[stage][key],
                                   atol=1e-4, err_msg=f"{stage}/{key}")
    np.testing.assert_array_equal(got["depth"].numpy(), got["stage3"]["depth"].numpy())


def test_depth_runner_two_batches(both):
    batch, want, port = both
    runner = DepthRunner(port, device="cpu")
    counts = (fused_costvol.fused_adaptive_cost_volume.launches,
              probstats.prob_volume_stats_fused.launches)
    first = runner(batch)
    second = runner(_batch(1))
    assert counts == (fused_costvol.fused_adaptive_cost_volume.launches,
                      probstats.prob_volume_stats_fused.launches)
    assert set(first) == {"depth", "photometric_confidence", "stage1", "stage2"}
    np.testing.assert_allclose(first["depth"], want["stage3"]["depth"], atol=1e-4)
    np.testing.assert_allclose(first["stage1"]["photometric_confidence"],
                               want["stage1"]["photometric_confidence"], atol=1e-4)
    assert second["depth"].shape == (B, H, W)
    assert second["stage2"]["depth"].shape == (B, H // 2, W // 2)
    assert all(np.isfinite(o["depth"]).all() for o in (first, second))
