"""The port's FMT against the JAX package's, in fp32 on the CPU: the sine
position encoding (1e-6), the SuperGlue encoding (eval and train, 5e-5),
linear attention and the FMT pathway over 3 views (5e-5), the cascade with
``use_fmt`` (and ``grad_method="undetach"``, which serving ignores) per
stage at 1e-4 (tests/test_fused_costvol.py:225's tolerance), the pathway's
gradients, and one fused training step with ``use_fmt`` and
``grad_method="undetach"`` against ``torch_helpers.jax_train_step``
(tests/test_torch_train_step_undetach.py holds the undetached step with
geo fusion, without FMT).

The FMT pathway's weights are the port's seeded init, carried to JAX by the
JAX package's own ``transplant_fmt_pathway`` (reference names); the
cascade's go through the weight bridge's table read backwards
(``port_flax_flat``).

The training step: the trained ``weights/bench_ckpt.npz`` with a seeded FMT
pathway, synthetic scenes 0 and 1 (B=2, N=3, 32x32, D0=16), ndepths
(8, 8, 8), ``fused_train`` (the kernels' plain versions on the CPU; JAX's
Pallas VJP in interpret mode), without geo fusion. Undetached, stage 2's
and 3's losses reach stage 1 through their hypotheses: the soft-argmin,
the 3-sigma band 3 sqrt(sum p (d - d^)^2) and ADIA's softmax (never
through the warp, whose sampling coordinates carry no gradient in either
package). The band's gradient is unbounded where its sum nears 0; on this
rig every stage's band stays above 0.1 (the test checks it), so no epsilon
is needed and none is added. Held: the losses at rtol 1e-4, every gradient
by ``assert_gradients_match`` (1e-3 of its tensor's largest JAX entry), and
the undetached step's stage-1 gradients differ from the detached step's.

Why no geo fusion and this scene pair: the step's gradient has dense kinks
at this size (ROADMAP Queue 3), and the seeded FMT makes them denser. Its
stage-1 depth is nearly flat, so geo fusion's deepest RGB-encoder blocks
(2x2 maps at 32x32, 8 values per channel over the batch) normalize
near-constant inputs with batch statistics, and their gradients are
rounding: with geo fusion every pair tried (0-1, 2-3, 4-5, 6-7) differed on
41 to 395 of 412 tensors, up to 79 % on ``rgb_encoder_layer5``. Without it,
pairs 0-1, 4-5 and 6-7 agree on all 274 tensors, and 2-3 differs on 201
(a flipped kink at stage 2). The FMT pathway's own gradients are held
module-level (``test_fmt_pathway_gradients``), and geo fusion's under the
undetached handoff in tests/test_torch_train_step_undetach.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from damvsnet_tpu.model import CascadeMVSNet as JCascade
from damvsnet_tpu.nn import fmt as jfmt
from damvsnet_tpu.nn import posenc as jposenc
from damvsnet_tpu.nn.precision import compute_dtype as jax_compute_dtype
from damvsnet_tpu.utils.transplant import transplant_fmt_pathway
from damvsnet_tpu_torch.model import CascadeMVSNet
from damvsnet_tpu_torch.nn.fmt import FMTWithPathway, linear_attention
from damvsnet_tpu_torch.nn.posenc import PositionEncodingSuperGlue, sine_position_encoding
from damvsnet_tpu_torch.utils.weights import _table as weight_table
from damvsnet_tpu_torch.utils.weights import module_state_dict_from_flax, module_table
from damvsnet_tpu_torch.utils.weights import state_dict_from_flax
from torch_helpers import (assert_gradients_match, cascade_batch, flax_two_pass_variance,
                           jax_train_step, port_flax_flat, port_train_step,
                           synthetic_train_batch, unflat)

torch.set_num_threads(1)

TOL = 5e-5
STAGES = ("stage1", "stage2", "stage3")
VIEWS = 3
JAX_PATHWAY = jfmt.FMTWithPathway(base_channels=8)


@pytest.mark.parametrize("shape", [(2, 8, 10, 32), (1, 5, 7, 16)])
def test_sine_position_encoding(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    want = np.asarray(jposenc.sine_position_encoding(jnp.asarray(x)))
    np.testing.assert_allclose(sine_position_encoding(torch.from_numpy(x)).numpy(), want,
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sine_table_kept_on_the_device_gives_the_same_values(rng, dtype):
    """The table is built once per (C, H, W, dtype, device) and reused; the
    sum is bitwise what adding the numpy table, cast to x's dtype, gives. A
    table first built under inference mode still serves a forward that
    records gradients."""
    from damvsnet_tpu_torch.nn import posenc
    x = torch.from_numpy(rng.standard_normal((2, 6, 9, 32)).astype(np.float32)).to(dtype)
    posenc._pe_table.cache_clear()
    with torch.inference_mode():
        first = posenc.sine_position_encoding(x)
    table = posenc._pe_table(32, 6, 9, dtype, x.device)
    assert not table.is_inference() and table.dtype == dtype
    assert posenc._pe_table(32, 6, 9, dtype, x.device) is table
    want = x + torch.from_numpy(posenc._pe_np(32, 6, 9)).to(dtype)[None]
    assert torch.equal(first, want)
    leaf = x.clone().requires_grad_(True)
    posenc.sine_position_encoding(leaf).float().sum().backward()
    assert torch.equal(leaf.grad, torch.ones_like(leaf))


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_superglue_position_encoding(rng, mode):
    x = rng.standard_normal((2, 6, 10, 32)).astype(np.float32)
    torch.manual_seed(0)
    port = PositionEncodingSuperGlue(32)
    flat = port_flax_flat(port, module_table("superglue"))
    port.load_state_dict(module_state_dict_from_flax(flat, "superglue"), strict=True)
    jmod = jposenc.PositionEncodingSuperGlue(d_model=32)
    train = mode == "train"
    port.train(train)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    with flax_two_pass_variance():
        want, mutated = jax.jit(lambda v, a: jmod.apply(v, a, train=train,
                                                        mutable=["batch_stats"]))(
            unflat(flat), jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=TOL)
    sd = port.state_dict()
    for i in range(2):
        for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
            new = np.asarray(mutated["batch_stats"][f"bn{i}"][theirs])
            np.testing.assert_allclose(sd[f"bn{i}.{ours}"].numpy(), new, rtol=1e-5, atol=1e-5)
            moved = not np.array_equal(new, flat[f"batch_stats/bn{i}/{theirs}"])
            assert moved == train, (i, ours)


@pytest.mark.parametrize("key_batch", [2, 1])
def test_linear_attention(rng, key_batch):
    """Keys and values of batch 1 serve both queries (the FMT's sources
    batched against one reference) exactly as if tiled."""
    q = rng.standard_normal((2, 50, 8, 4)).astype(np.float32)
    k = rng.standard_normal((key_batch, 60, 8, 4)).astype(np.float32)
    v = rng.standard_normal((key_batch, 60, 8, 4)).astype(np.float32)
    tile = lambda a: np.repeat(a, 2 // key_batch, axis=0)
    want = np.asarray(jfmt.linear_attention(jnp.asarray(q), jnp.asarray(tile(k)),
                                            jnp.asarray(tile(v))))
    got = linear_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def _pathway_inputs(rng, b=2, h=8, w=12):
    """Per view {stage: NHWC} features of the FPN's widths."""
    return [{f"stage{s + 1}": rng.standard_normal((b, h << s, w << s, 32 >> s))
             .astype(np.float32) for s in range(3)} for _ in range(VIEWS)]


def _pathway_both(rng, dtype):
    views = _pathway_inputs(rng)
    torch.manual_seed(0)
    port = FMTWithPathway(8)
    variables = transplant_fmt_pathway(port.state_dict())
    jviews = [{k: jnp.asarray(a, dtype) for k, a in v.items()} for v in views]
    with jax_compute_dtype(None if dtype == jnp.float32 else dtype):
        want = jax.jit(JAX_PATHWAY.apply)(variables, jviews)
    stacked = {s: torch.from_numpy(np.stack([v[s] for v in views], axis=1)) for s in STAGES}
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    with torch.no_grad():
        got = port({s: t.to(tdtype) for s, t in stacked.items()}, tdtype)
    return want, got


def test_fmt_pathway(rng):
    """Every view's three stages; the reference view through the 4 self
    layers, each source through self and cross layers, batched."""
    want, got = _pathway_both(rng, jnp.float32)
    for v in range(VIEWS):
        for s in STAGES:
            np.testing.assert_allclose(got[s][:, v].numpy(), np.asarray(want[v][s]), rtol=0,
                                       atol=TOL, err_msg=f"view {v} {s}")


def test_fmt_pathway_gradients(rng):
    """The gradients of <pathway(views), cotangent> with respect to every
    view's features and every weight, through torch autograd and jax.grad."""
    views = _pathway_inputs(rng)
    cots = [{k: rng.standard_normal(a.shape).astype(np.float32) for k, a in v.items()}
            for v in views]
    torch.manual_seed(0)
    port = FMTWithPathway(8)
    variables = transplant_fmt_pathway(port.state_dict())

    def loss(var, vs):
        out = JAX_PATHWAY.apply(var, vs)
        return sum(jnp.sum(out[v][k] * cots[v][k]) for v in range(VIEWS) for k in out[v])
    gvar, gin = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        variables, [{k: jnp.asarray(a) for k, a in v.items()} for v in views])
    stacked = {s: torch.from_numpy(np.stack([v[s] for v in views], axis=1)).requires_grad_()
               for s in STAGES}
    out = port(stacked, torch.float32)
    sum((out[s] * torch.from_numpy(np.stack([c[s] for c in cots], axis=1))).sum()
        for s in STAGES).backward()
    for s in STAGES:
        want = np.stack([np.asarray(g[s]) for g in gin], axis=1)
        np.testing.assert_allclose(stacked[s].grad.numpy(), want, rtol=0,
                                   atol=TOL * max(1.0, float(np.abs(want).max())), err_msg=s)
    want = {k: v.numpy() for k, v in module_state_dict_from_flax(
        {"params/" + "/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
         for kp, v in jax.tree_util.tree_flatten_with_path(gvar["params"])[0]},
        "fmt_pathway").items()}
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=0,
                                   atol=TOL * max(1.0, float(np.abs(want[name]).max())),
                                   err_msg=name)


def test_fmt_pathway_bf16_rounds_where_jax_does(rng):
    """Under bf16 both packages return every stage in fp32 (LayerNorm's fp32
    output, the pathway's convolutions in the promoted dtype) and agree to
    a few bf16 steps: the Dense layers round at the same points."""
    want, got = _pathway_both(rng, jnp.bfloat16)
    for v in range(VIEWS):
        for s in STAGES:
            assert got[s].dtype == torch.float32 and want[v][s].dtype == jnp.float32
            np.testing.assert_allclose(got[s][:, v].numpy(), np.asarray(want[v][s]), rtol=0,
                                       atol=0.05, err_msg=f"view {v} {s}")


# ---- the cascade with FMT ----


@pytest.fixture(scope="module")
def fmt_cascades():
    """JAX's and the port's serving outputs with use_fmt on the same
    weights (the port's seeded init, its BN statistics moved) and batch."""
    batch = cascade_batch(0)
    jargs = (jnp.asarray(batch["imgs"]),
             {k: jnp.asarray(v) for k, v in batch["proj_matrices"].items()},
             jnp.asarray(batch["depth_values"]))
    torch.manual_seed(0)
    port = CascadeMVSNet(ndepths=(8, 8, 8), device="cpu", use_fmt=True,
                         grad_method="undetach")
    flat = port_flax_flat(port, weight_table(use_fmt=True))
    port.load_state_dict(state_dict_from_flax(flat, use_fmt=True), strict=True)
    jmodel = JCascade(ndepths=(8, 8, 8), use_fmt=True, clamp_samples=True)
    want = jax.jit(jmodel.apply, static_argnames=("train",))(unflat(flat), *jargs, train=False)
    with torch.inference_mode():
        got = port(torch.from_numpy(batch["imgs"]),
                   {k: torch.from_numpy(v) for k, v in batch["proj_matrices"].items()},
                   torch.from_numpy(batch["depth_values"]))
    return want, got


@pytest.mark.parametrize("stage", STAGES)
def test_fmt_cascade(fmt_cascades, stage):
    want, got = fmt_cascades
    for key in ("depth", "photometric_confidence", "variance", "prob_volume", "depth_values"):
        np.testing.assert_allclose(got[stage][key].numpy(), np.asarray(want[stage][key]),
                                   atol=1e-4, err_msg=f"{stage}/{key}")


# ---- one fused training step, FMT and the undetached handoff ----

NDEPTHS = (8, 8, 8)
SCENES = (0, 1)
CONFIG = {"fused_train": True, "clamp_samples": True, "use_fmt": True, "use_geo_fusion": False}


def _fmt_flat():
    """A seeded FMT pathway as flat flax variables under ``fmt_pathway``."""
    torch.manual_seed(0)
    flat = port_flax_flat(FMTWithPathway(8), module_table("fmt_pathway"))
    return {k.replace("params/", "params/fmt_pathway/", 1): v for k, v in flat.items()}


@pytest.fixture(scope="module")
def steps():
    """The JAX step (the Pallas VJP in interpret mode) and the port's,
    undetached; and the port's step detached, on the same weights."""
    batch = synthetic_train_batch(SCENES)
    extra = _fmt_flat()
    params, stats, want = jax_train_step(batch, NDEPTHS, extra_flat=extra,
                                         sampler_opts={"interpret": True},
                                         grad_method="undetach", **CONFIG)
    got = port_train_step(batch, params, stats, NDEPTHS, grad_method="undetach", **CONFIG)
    detached = port_train_step(batch, params, stats, NDEPTHS, grad_method="detach", **CONFIG)
    return want, got, detached


def test_undetached_step_losses_match(steps):
    want, got, _ = steps
    assert got["min_sigma"] > 0.1, got["min_sigma"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4,
                               err_msg="total, depth, cpc")


def test_undetached_step_gradients_match(steps):
    want, got, _ = steps
    assert_gradients_match(want, got)
    assert float(got["model"].FMT_with_pathway.FMT.layers[0].linear1.weight.grad
                 .abs().sum()) > 0


def test_undetached_handoff_changes_stage1_gradients(steps):
    """Stages 2 and 3 send gradient into stage 1's regularizer only when
    undetached; the losses are the same step's."""
    _, got, detached = steps
    np.testing.assert_allclose(got["losses"], detached["losses"], rtol=1e-6)
    a = got["model"].cost_regularization[0].prob.weight.grad
    b = detached["model"].cost_regularization[0].prob.weight.grad
    assert float((a - b).abs().max()) > 1e-3 * float(b.abs().max())
    c = got["model"].cost_regularization[2].prob.weight.grad
    d = detached["model"].cost_regularization[2].prob.weight.grad
    torch.testing.assert_close(c, d, rtol=1e-5, atol=1e-7)
