"""The port's default training step as a whole against the JAX package's,
in fp32 on the CPU: the non-fused configuration both CLIs build without
``--fused_train`` (``CascadeMVSNet(fused_train=False, clamp_samples=False)``,
geo fusion, adaptive aggregation, detached handoff) at ndepths (8, 8, 8),
on the trained ``weights/bench_ckpt.npz`` and synthetic scenes 2 and 3
(B=2, N=3, 32x32, D0=16).

Both sides sample with the plain gather (JAX: its XLA sampler), run each
stage's weight net as a module with batch-statistics BN on every view's
squared difference (its running statistics chained over the views), and
take the plain statistics tail. The port launches no kernel.

Held as tests/test_torch_train_step.py holds the fused step (flax's batch
variance two-pass; the same scene pair, on which both packages take every
ReLU decision alike): the losses at rtol 1e-5, every running statistic at
1e-5 (the weight nets' included, which move here), every gradient within
1e-3 of its tensor's largest JAX entry — except in the weight nets, where
each conv + BN block's three tensors are held within 1e-3 of the block's
largest JAX entry. Each block's BN normalizes a single channel with batch
statistics, so the loss is invariant, up to BN's eps, to the scale of the
block's input: the exact gradient of the 1 -> 1 conv's weight vanishes
(w * dL/dw = 0 but for eps), and that of the first BN's weight is pinned to
its bias's (the second BN undoes a joint scaling of both). What fp32 gives
for such a gradient is the rounding left over from cancelling sums over
every voxel and view, which the two packages round differently; measured
against the block's own scale, both agree to 1e-3.

With the plain warp sampling align_corners=True (JAX's ``sampler_opts=
{"align_corners": True}``, the accuracy chain's training step), the step
is held by its losses at rtol 1e-4 and its whole gradient's relative L2 at
1e-2, as chip_smoke.py holds the card's steps.
"""
import numpy as np
import pytest
import torch

from torch_helpers import (assert_gradients_match, assert_running_statistics_match,
                           assert_step_matches_by_l2, jax_train_step, port_train_step,
                           synthetic_train_batch)

torch.set_num_threads(1)

NDEPTHS = (8, 8, 8)
SCENES = (2, 3)
CONFIG = {"fused_train": False, "clamp_samples": False}


@pytest.fixture(scope="module")
def both():
    batch = synthetic_train_batch(SCENES)
    params, stats, want = jax_train_step(batch, NDEPTHS, **CONFIG)
    return want, port_train_step(batch, params, stats, NDEPTHS, **CONFIG)


def test_losses_match(both):
    want, got = both
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5,
                               err_msg="total, depth, cpc")


def _block(name):
    """A weight-net tensor's conv + BN block (``DepthNet.weight_net.i.w_net.j``);
    any other tensor is its own group."""
    return name.rsplit(".", 2)[0] if name.startswith("DepthNet.") else name


def test_every_gradient_matches(both):
    assert_gradients_match(*both, group=_block)


def test_running_statistics_match(both):
    assert_running_statistics_match(*both)


def test_weight_net_statistics_move(both):
    """The 12 running-statistics tensors of the three weight nets move, as
    JAX's do, and every weight-net parameter gets a gradient."""
    want, got = both
    sd = got["model"].state_dict()
    names = [k for k in sd if k.startswith("DepthNet.weight_net")
             and k.endswith(("running_mean", "running_var"))]
    assert len(names) == 12
    for name in names:
        assert not torch.equal(sd[name], got["before"][name]), name
    for i, net in enumerate(got["model"].DepthNet.weight_net):
        for name, p in net.named_parameters():
            assert float(p.grad.abs().sum()) > 0, f"weight_net.{i}.{name}"


def test_align_corners_step_matches():
    batch = synthetic_train_batch(SCENES)
    params, stats, want = jax_train_step(batch, NDEPTHS,
                                         sampler_opts={"align_corners": True}, **CONFIG)
    got = port_train_step(batch, params, stats, NDEPTHS, align_corners=True, **CONFIG)
    assert_step_matches_by_l2(want, got)
