"""The port's training step with the undetached stage handoff
(``grad_method="undetach"``) against the JAX package's, in fp32 on the CPU:
the fused configuration of tests/test_torch_train_step.py (geo fusion,
adaptive aggregation, ``fused_train``, clamped hypotheses, the trained
``weights/bench_ckpt.npz``, synthetic scenes 2 and 3, B=2, N=3, 32x32,
D0=16, ndepths (8, 8, 8)), its handoff undetached.

Undetached, stage 2's and 3's losses reach stage 1 through their
hypotheses: the soft-argmin, the 3-sigma band 3 sqrt(sum p (d - d^)^2),
ADIA's softmax and the clamp (``torch.minimum(torch.maximum())``, which
passes half the gradient at a tie as ``jnp.clip`` does; ``torch.clamp``
would pass all of it), never through the warp, whose sampling coordinates
carry no gradient in either package. The band's gradient is unbounded
where its sum nears 0; on this rig every stage's band stays above 0.1 (the
test checks it), so no epsilon is needed and none is added.

Held as tests/test_torch_train_step.py holds the detached step: the losses
at rtol 1e-5, every gradient within 1e-3 of its tensor's largest JAX entry
(+1e-7), every running statistic at 1e-5; and the handoff matters: stage
1's gradients move against the detached step's, stage 3's do not.
"""
import numpy as np
import pytest
import torch

from torch_helpers import (assert_gradients_match, assert_running_statistics_match,
                           jax_train_step, port_train_step, synthetic_train_batch)

torch.set_num_threads(1)

NDEPTHS = (8, 8, 8)
SCENES = (2, 3)
CONFIG = {"fused_train": True, "clamp_samples": True}


@pytest.fixture(scope="module")
def steps():
    """The JAX step undetached (the fused kernels in interpret mode), the
    port's undetached and detached steps, on the same weights."""
    batch = synthetic_train_batch(SCENES)
    params, stats, want = jax_train_step(batch, NDEPTHS, sampler_opts={"interpret": True},
                                         grad_method="undetach", **CONFIG)
    got = port_train_step(batch, params, stats, NDEPTHS, grad_method="undetach", **CONFIG)
    detached = port_train_step(batch, params, stats, NDEPTHS, **CONFIG)
    return want, got, detached


def test_losses_match(steps):
    want, got, _ = steps
    assert got["min_sigma"] > 0.1, got["min_sigma"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5,
                               err_msg="total, depth, cpc")


def test_every_gradient_matches(steps):
    want, got, _ = steps
    assert_gradients_match(want, got)


def test_running_statistics_match(steps):
    want, got, _ = steps
    assert_running_statistics_match(want, got)


def test_handoff_gradient_reaches_stage1_only_undetached(steps):
    _, got, detached = steps
    np.testing.assert_allclose(got["losses"], detached["losses"], rtol=1e-6)
    named = lambda r: dict(r["model"].named_parameters())
    u, d = named(got), named(detached)
    stage1 = [k for k in u if k.startswith("cost_regularization.0.")]
    moved = sum(float((u[k].grad - d[k].grad).abs().max()) > 1e-3 * float(d[k].grad.abs().max())
                for k in stage1)
    assert moved > len(stage1) // 2, (moved, len(stage1))
    for k in (k for k in u if k.startswith("cost_regularization.2.")):
        torch.testing.assert_close(u[k].grad, d[k].grad, rtol=1e-5, atol=1e-7)
