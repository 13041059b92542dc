"""The port's training step as a whole against the JAX package's, in fp32
on the CPU: the fused-VJP training configuration (``CascadeMVSNet(
fused_train=True, clamp_samples=True)``, geo fusion, adaptive aggregation,
detached handoff) at ndepths (8, 8, 8), on the same weights (the trained
``weights/bench_ckpt.npz``, passed through the bridge) and the same batch
(synthetic scenes 2 and 3, B=2, N=3, 32x32, D0=16).

JAX: ``jax.value_and_grad`` of ``cas_mvsnet_loss(use_cpc=True)`` under
``train=True, mutable=["batch_stats"]`` (the fused kernels in interpret
mode). The port: ``model.train()``, the forward, the loss, ``backward()``
(the plain versions, as the wrappers take on CPU tensors).

Held: total, depth and CPC losses at rtol 1e-5; every running mean and
variance at 1e-5; the weight nets' running statistics unchanged; every
parameter's gradient finite and within 1e-3 of its tensor's largest JAX
entry (+1e-7), matched by name through the bridge.

Two choices make fp32 parity at these tolerances possible:

* flax's ``BatchNorm`` computes the batch variance one-pass, as
  E[x^2] - E[x]^2 (``use_fast_variance``), which loses digits to
  cancellation that the two-pass variance (torch's, and the port's) keeps;
  with it the step's losses differ by more than 1e-5. The JAX side runs
  with ``use_fast_variance=False``: the same function, computed two-pass.
* The step's gradient is piecewise smooth, and at 32x32 its kinks are
  dense: millions of ReLU inputs, and BN over a handful of values per
  channel in the small maps. Where the two packages' rounding puts one
  ReLU input on opposite sides of zero, many tensors' gradients differ by
  percents (``scripts/grad_sensitivity_torch.py`` shows the port's own
  gradient jumping so under a 1e-6 change of the images, and from random
  init weights under 1e-7). Scenes 2 and 3 with the trained weights are a
  pair on which the two packages take every such decision alike on the
  CPU, so the 1e-3-per-tensor tolerance holds; a change to either
  package's arithmetic can move a decision and needs another pair.
"""
import numpy as np
import pytest
import torch

import flax.linen.normalization as flax_norm
import jax
import jax.numpy as jnp

from damvsnet_tpu.data.common import collate
from damvsnet_tpu.data.synthetic import make_synthetic_sample
from damvsnet_tpu.losses import cas_mvsnet_loss as jloss
from damvsnet_tpu.model import CascadeMVSNet as JCascade
from damvsnet_tpu_torch.losses import cas_mvsnet_loss
from damvsnet_tpu_torch.model import CascadeMVSNet
from damvsnet_tpu_torch.ops.kernels import fused_costvol
from torch_helpers import port_named

torch.set_num_threads(1)

NDEPTHS = (8, 8, 8)
SIZE = 32
SCENES = (2, 3)
WEIGHTS = "weights/bench_ckpt.npz"


def _tree(flat, collection):
    tree = {}
    for key, v in flat.items():
        coll, *path, leaf = key.split("/")
        if coll != collection:
            continue
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(v, np.float32)
    return tree


def _batch():
    batch = collate([make_synthetic_sample(SIZE, SIZE, 3, 16, seed=s) for s in SCENES])
    return {k: batch[k] for k in ("imgs", "proj_matrices", "depth_values", "depth", "mask")}


def _two_pass_batch_stats(compute_stats):
    def stats(*args, **kwargs):
        kwargs["use_fast_variance"] = False
        return compute_stats(*args, **kwargs)
    return stats


def jax_step():
    """The JAX step, with flax's BatchNorm variance two-pass:
    (batch, params, stats, want)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax_norm, "_compute_stats",
                   _two_pass_batch_stats(flax_norm._compute_stats))
        return _jax_step()


def _jax_step():
    batch = _batch()
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    with np.load(WEIGHTS) as npz:
        flat = {k: npz[k] for k in npz.files}
    params, stats = _tree(flat, "params"), _tree(flat, "batch_stats")
    jmodel = JCascade(ndepths=NDEPTHS, fused_train=True, clamp_samples=True,
                      sampler_opts={"interpret": True})

    def loss_fn(params, stats):
        out, mutated = jmodel.apply(
            {"params": params, "batch_stats": stats}, jb["imgs"],
            jb["proj_matrices"], jb["depth_values"], train=True,
            mutable=["batch_stats"])
        total, depth_loss, cpc = jloss(out, jb["imgs"], jb["proj_matrices"],
                                       jb["depth"], jb["mask"], use_cpc=True)
        return total, (depth_loss, cpc, mutated["batch_stats"])

    (total, (depth_loss, cpc, new_stats)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params, stats)
    want = {"losses": np.array([total, depth_loss, cpc], np.float32),
            "grads": port_named(grads, stats),
            "stats": port_named(params, new_stats)}
    return batch, params, stats, want


def port_step(batch, params, stats):
    """The port's step on the same weights and inputs."""
    model = CascadeMVSNet(ndepths=NDEPTHS, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in
                           port_named(params, stats).items()})
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tb = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.asarray(a)), batch)
    counts = (fused_costvol.fused_adaptive_cost_volume.launches,
              fused_costvol.fused_adaptive_cost_volume_backward.launches)
    model.train()
    # oneDNN's CPU convolution backward corrupts the heap at these shapes
    # (a segfault at stage 3); torch's own CPU convolutions are used instead
    with torch.backends.mkldnn.flags(enabled=False):
        out = model(tb["imgs"], tb["proj_matrices"], tb["depth_values"])
        losses = cas_mvsnet_loss(out, tb["imgs"], tb["proj_matrices"], tb["depth"],
                                 tb["mask"], use_cpc=True)
        losses[0].backward()
    assert counts == (fused_costvol.fused_adaptive_cost_volume.launches,
                      fused_costvol.fused_adaptive_cost_volume_backward.launches)
    return {"losses": np.array([float(x.detach()) for x in losses], np.float32),
            "model": model, "before": before}


@pytest.fixture(scope="module")
def both():
    """The JAX step (run once) and the port's, on the same weights."""
    batch, params, stats, want = jax_step()
    return want, port_step(batch, params, stats)


def test_losses_match(both):
    want, got = both
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5,
                               err_msg="total, depth, cpc")


def test_every_gradient_matches(both):
    want, got = both
    bad = []
    named = dict(got["model"].named_parameters())
    assert set(named) <= set(want["grads"])
    for name, p in named.items():
        assert p.grad is not None, name
        g = p.grad.numpy()
        assert np.isfinite(g).all(), name
        ref = want["grads"][name]
        tol = 1e-3 * np.abs(ref).max() + 1e-7
        err = np.abs(g - ref).max()
        if err > tol:
            bad.append(f"{name}: {err:.3g} > {tol:.3g}")
    assert not bad, bad


def test_weight_net_gradients_are_not_vacuous(both):
    _, got = both
    for i in range(3):
        g = got["model"].DepthNet.weight_net[i].w_net[0].conv.weight.grad
        assert float(g.abs().sum()) > 0, i


def test_running_statistics_match(both):
    want, got = both
    sd = got["model"].state_dict()
    names = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert names
    for name in names:
        np.testing.assert_allclose(sd[name].numpy(), want["stats"][name],
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_weight_net_statistics_do_not_move(both):
    want, got = both
    sd = got["model"].state_dict()
    names = [k for k in sd if k.startswith("DepthNet.weight_net")
             and k.endswith(("running_mean", "running_var"))]
    assert len(names) == 12
    for name in names:
        assert torch.equal(sd[name], got["before"][name]), name
        np.testing.assert_array_equal(want["stats"][name], sd[name].numpy())
    moved = [k for k in sd if k.endswith("running_mean")
             and not k.startswith("DepthNet")
             and not torch.equal(sd[k], got["before"][k])]
    assert moved
