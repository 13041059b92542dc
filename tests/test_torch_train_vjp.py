"""Kernel K3 (the backward of the fused adaptive cost volume): the port's
plain version against ``jax.grad`` through the JAX package's custom VJP
(``fused_adaptive_cost_volume_vjp``, Pallas in interpret mode), on the
same numpy inputs.

The port's gradients come three ways, all on CPU tensors: torch autograd
through the plain forward, autograd through the public wrapper (which on
the CPU is that plain forward, and launches nothing), and the backward
wrapper ``fused_adaptive_cost_volume_backward`` (on the CPU, the plain
backward). Tolerances are tests/test_fused_costvol_vjp.py's: 1e-4 on the
feature gradients, 2e-4 on the weight-net scalars (fp32 sums in another
order over every voxel).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from damvsnet_tpu.model.cascade import fuse_projection_matrices
from damvsnet_tpu.ops.pallas.fused_costvol_vjp import fused_adaptive_cost_volume_vjp
from damvsnet_tpu_torch.ops.kernels import fused_costvol
from conftest import make_rig

torch.set_num_threads(1)

# (B, N, H, W, C, D, per-pixel hypotheses, align_corners): the setup of
# tests/test_fused_costvol_vjp.py, then a [B, D] sweep at C=32, then the
# first with the grid un-normalized align_corners=True
CASES = {"c8_per_pixel": (1, 3, 16, 32, 8, 8, True, False),
         "c32_sweep": (2, 3, 16, 32, 32, 8, False, False),
         "c8_per_pixel_align_corners": (1, 3, 16, 32, 8, 8, True, True)}


def _inputs(case, seed=0):
    b, nv, h, w, c, d, per_pixel, align_corners = CASES[case]
    rs = np.random.default_rng(seed)
    _, projs = make_rig(batch=b, num_views=nv, height=h, width=w, seed=seed)
    fused = np.array(fuse_projection_matrices(jnp.asarray(projs)))
    sweep = np.linspace(4.0, 8.0, d, dtype=np.float32)
    if per_pixel:
        dv = np.broadcast_to(sweep[None, :, None, None], (b, d, h, w)).copy()
    else:
        dv = np.broadcast_to(sweep[None], (b, d)).copy()
    return {
        "ref": rs.random((b, h, w, c), np.float32),
        "srcs": [rs.random((b, h, w, c), np.float32) for _ in range(nv - 1)],
        "ref_proj": fused[:, 0], "src_projs": [fused[:, i] for i in range(1, nv)],
        "dv": dv, "w1": (rs.standard_normal(c) * 0.1).astype(np.float32),
        "scal": (np.float32(0.05), np.float32(1.3), np.float32(0.02)),
        "cot": rs.standard_normal((b, d, h, w, c)).astype(np.float32),
        "align_corners": align_corners,
    }


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """(inputs, JAX gradients of sum(vol * cot) with respect to ref, srcs,
    w1, b1, w2, b2), the JAX side run once per case."""
    x = _inputs(request.param)
    ref_proj = jnp.asarray(x["ref_proj"])
    src_projs = [jnp.asarray(p) for p in x["src_projs"]]
    cot = jnp.asarray(x["cot"])

    def loss(ref, srcs, w1, b1, w2, b2):
        vol, _ = fused_adaptive_cost_volume_vjp(
            ref, srcs, ref_proj, src_projs, jnp.asarray(x["dv"]), w1, b1, w2, b2,
            align_corners=x["align_corners"], interpret=True)
        return jnp.sum(vol.astype(jnp.float32) * cot)

    grads = jax.grad(loss, argnums=(0, 1, 2, 3, 4, 5))(
        jnp.asarray(x["ref"]), [jnp.asarray(s) for s in x["srcs"]],
        jnp.asarray(x["w1"]), *(jnp.float32(s) for s in x["scal"]))
    want = (np.asarray(grads[0]), [np.asarray(g) for g in grads[1]],
            *(np.asarray(g) for g in grads[2:]))
    return x, want


def _torch_args(x):
    t = torch.from_numpy
    return (t(x["ref"]), [t(s) for s in x["srcs"]], t(x["ref_proj"]),
            [t(p) for p in x["src_projs"]], t(x["dv"]), t(x["w1"]),
            *(torch.tensor(s) for s in x["scal"]))


def _autograd(fn, x):
    ref, srcs, ref_proj, src_projs, dv, w1, b1, w2, b2 = _torch_args(x)
    leaves = [ref, *srcs, w1, b1, w2, b2]
    for t in leaves:
        t.requires_grad_()
    vol = fn(ref, srcs, ref_proj, src_projs, dv, w1, b1, w2, b2, x["align_corners"])
    (vol.float() * torch.from_numpy(x["cot"])).sum().backward()
    n = len(srcs)
    return (ref.grad, [s.grad for s in srcs], *(t.grad for t in leaves[1 + n:]))


def _compare(got, want):
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=1e-4, atol=1e-4,
                               err_msg="dref")
    for g, wnt in zip(got[1], want[1]):
        np.testing.assert_allclose(g.numpy(), wnt, rtol=1e-4, atol=1e-4,
                                   err_msg="dsrc")
    for name, g, wnt in zip(("w1", "b1", "w2", "b2"), got[2:], want[2:]):
        np.testing.assert_allclose(np.asarray(g.detach().numpy()).reshape(np.shape(wnt)),
                                   wnt, rtol=2e-4, atol=2e-4, err_msg=name)


def test_plain_autograd_matches_jax_vjp(case):
    x, want = case
    _compare(_autograd(fused_costvol.fused_adaptive_cost_volume_plain, x), want)


def test_wrapper_on_cpu_is_plain_and_launches_nothing(case):
    x, want = case
    counts = (fused_costvol.fused_adaptive_cost_volume.launches,
              fused_costvol.fused_adaptive_cost_volume_backward.launches)
    _compare(_autograd(fused_costvol.fused_adaptive_cost_volume, x), want)
    assert counts == (fused_costvol.fused_adaptive_cost_volume.launches,
                      fused_costvol.fused_adaptive_cost_volume_backward.launches)


def test_backward_wrapper_on_cpu_matches_jax_vjp(case):
    x, want = case
    got = fused_costvol.fused_adaptive_cost_volume_backward(
        torch.from_numpy(x["cot"]), *_torch_args(x), x["align_corners"])
    _compare(got, want)
    assert fused_costvol.fused_adaptive_cost_volume_backward.launches == 0


def test_no_gradient_to_geometry_or_hypotheses(case):
    """The sampling grid is built from detached inputs, as under the
    reference's no_grad grid: depth values and projections get none."""
    x, _ = case
    ref, srcs, ref_proj, src_projs, dv, w1, b1, w2, b2 = _torch_args(x)
    for t in (ref, dv, ref_proj, *src_projs):
        t.requires_grad_()
    vol = fused_costvol.fused_adaptive_cost_volume(
        ref, srcs, ref_proj, src_projs, dv, w1, b1, w2, b2, x["align_corners"])
    vol.sum().backward()
    assert ref.grad is not None
    assert dv.grad is None and ref_proj.grad is None
    assert all(p.grad is None for p in src_projs)
