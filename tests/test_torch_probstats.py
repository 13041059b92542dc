"""Kernel K2 (probability-volume statistics): the port's plain version and
its wrapper on CPU tensors against the JAX Pallas kernel (interpret mode).

prob, depth and the 3-sigma band agree to 1e-5. The confidence gathers at
trunc(sum p * d), and two implementations that sum in another order can
land on either side of an integer, which moves the 4-tap window by one:
at most 2 pixels may differ by more than 1e-5 (none do on these seeds).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from damvsnet_tpu.ops.pallas.probstats import prob_volume_stats_pallas
from damvsnet_tpu.ops.regression import prob_volume_stats as jstats
from damvsnet_tpu_torch.ops.kernels import probstats
from damvsnet_tpu_torch.ops.regression import prob_volume_stats

torch.set_num_threads(1)

MAX_CONF_FLIPS = 2


@pytest.mark.parametrize("per_pixel", [False, True])
def test_stats_match_pallas(rng, per_pixel):
    b, d, h, w = 2, 16, 8, 24
    cost = (3 * rng.standard_normal((b, d, h, w))).astype(np.float32)
    if per_pixel:
        dv = np.sort(4 + 4 * rng.random((b, d, h, w)), axis=1).astype(np.float32)
    else:
        dv = np.linspace(4, 8, d, dtype=np.float32)[None].repeat(b, 0)
    want = prob_volume_stats_pallas(jnp.asarray(cost), jnp.asarray(dv),
                                    interpret=True)
    launches = probstats.prob_volume_stats_fused.launches
    outs = (prob_volume_stats(torch.from_numpy(cost), torch.from_numpy(dv)),
            probstats.prob_volume_stats_fused(torch.from_numpy(cost),
                                              torch.from_numpy(dv)))
    assert probstats.prob_volume_stats_fused.launches == launches
    for got in outs:
        for key in ("prob_volume", "depth", "variance"):
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                       atol=1e-5, err_msg=key)
        dc = np.abs(got["photometric_confidence"].numpy()
                    - np.asarray(want["photometric_confidence"]))
        assert int((dc > 1e-5).sum()) <= MAX_CONF_FLIPS


def test_confidence_passes_no_gradient(rng):
    """A loss on the photometric confidence gives the cost no gradient, in
    both packages (both detach the confidence's input, as the reference
    does); one on the depth does."""
    cost = (3 * rng.standard_normal((1, 8, 4, 6))).astype(np.float32)
    dv = np.linspace(4, 8, 8, dtype=np.float32)[None]

    def jloss(c, key):
        return jnp.sum(jstats(c, jnp.asarray(dv))[key] ** 2)

    for key, zero in (("photometric_confidence", True), ("depth", False)):
        jg = np.asarray(jax.grad(jloss)(jnp.asarray(cost), key))
        t = torch.from_numpy(cost).requires_grad_()
        out = prob_volume_stats(t, torch.from_numpy(dv))[key]
        assert out.requires_grad != zero, key
        g = (torch.autograd.grad((out ** 2).sum(), t)[0].numpy() if out.requires_grad
             else np.zeros_like(cost))
        assert (np.abs(jg).max() == 0) == zero, key
        assert (np.abs(g).max() == 0) == zero, key
        np.testing.assert_allclose(g, jg, rtol=1e-5, atol=1e-6, err_msg=key)


def test_confidence_window_edges():
    """All mass on the first or last hypothesis: the window is clipped at
    the volume's ends and the confidence is 1."""
    d = 8
    cost = np.full((1, d, 1, 2), -50.0, np.float32)
    cost[0, 0, 0, 0] = 50.0
    cost[0, d - 1, 0, 1] = 50.0
    out = probstats.prob_volume_stats_fused(
        torch.from_numpy(cost), torch.linspace(1, 2, d)[None])
    np.testing.assert_allclose(out["photometric_confidence"].numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(out["depth"].numpy()[0, 0], [1.0, 2.0], atol=1e-6)


@pytest.mark.parametrize("per_pixel", [False, True])
def test_bf16_cost_equals_its_fp32_upcast(rng, per_pixel):
    """A bf16 cost (the cascade hands K2 the regularizer's bf16 output) gives
    exactly what its fp32 upcast gives, in the plain version and in the
    wrapper on CPU tensors; every output is fp32."""
    b, d, h, w = 2, 16, 8, 24
    cost = torch.from_numpy((3 * rng.standard_normal((b, d, h, w))).astype(np.float32))
    cost = cost.to(torch.bfloat16)
    if per_pixel:
        dv = np.sort(4 + 4 * rng.random((b, d, h, w)), axis=1).astype(np.float32)
    else:
        dv = np.linspace(4, 8, d, dtype=np.float32)[None].repeat(b, 0)
    dv = torch.from_numpy(dv)
    want = prob_volume_stats(cost.float(), dv)
    for fn in (prob_volume_stats, probstats.prob_volume_stats_fused):
        got = fn(cost, dv)
        for key, value in want.items():
            assert got[key].dtype == torch.float32
            assert torch.equal(got[key], value), (fn.__name__, key)
