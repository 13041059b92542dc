"""The port's variance training step as a whole against the JAX package's,
in fp32 on the CPU: ``CascadeMVSNet(agg_mode="variance", fused_train=False,
clamp_samples=False)`` (what both CLIs build from ``--agg_mode variance``),
geo fusion, detached handoff, at ndepths (8, 8, 8), on the trained
``weights/bench_ckpt.npz`` less its weight nets and synthetic scenes 2 and
3 (B=2, N=3, 32x32, D0=16).

Both sides take the variance over the views of the plain gather's samples
(JAX: its XLA sampler; the port's K4 is inference-only, as on the TPU) and
the plain statistics tail; the port launches no kernel. Held as
tests/test_torch_train_step.py holds the fused step: the losses at rtol
1e-5, every running statistic at 1e-5, every gradient within 1e-3 of its
tensor's largest JAX entry. (A file of its own, so that xdist can run it
beside the adaptive one.)
"""
import numpy as np
import pytest
import torch

from torch_helpers import (assert_gradients_match, assert_running_statistics_match,
                           jax_train_step, port_train_step, synthetic_train_batch)

torch.set_num_threads(1)

NDEPTHS = (8, 8, 8)
SCENES = (2, 3)
CONFIG = {"agg_mode": "variance", "fused_train": False, "clamp_samples": False}


@pytest.fixture(scope="module")
def both():
    batch = synthetic_train_batch(SCENES)
    params, stats, want = jax_train_step(batch, NDEPTHS, **CONFIG)
    return want, port_train_step(batch, params, stats, NDEPTHS, **CONFIG)


def test_losses_match(both):
    want, got = both
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5,
                               err_msg="total, depth, cpc")


def test_every_gradient_matches(both):
    assert_gradients_match(*both)


def test_running_statistics_match(both):
    assert_running_statistics_match(*both)
