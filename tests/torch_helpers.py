"""Inputs and steps shared by the PyTorch port's tests (a helper module,
not a test file: pytest collects nothing here)."""
import contextlib

import numpy as np
import pytest

from conftest import make_rig

TRAIN_WEIGHTS = "weights/bench_ckpt.npz"


def fused_projs(batch, num_views, height, width, seed=0):
    """The fused K·[R|t] projection [B, 4, 4] of each view of
    ``make_rig``'s rig, as a list of fp32 numpy arrays."""
    _, projs = make_rig(batch=batch, num_views=num_views, height=height,
                        width=width, seed=seed)
    fused = []
    for v in range(num_views):
        f = np.broadcast_to(np.eye(4, dtype=np.float32), (batch, 4, 4)).copy()
        f[:, :3, :4] = np.einsum("bij,bjk->bik", projs[:, v, 1, :3, :3],
                                 projs[:, v, 0, :3, :4])
        fused.append(f)
    return fused


TABLE_KEYS = ("agg_mode", "use_geo_fusion", "use_fmt", "reg_mode", "refine", "arch_mode")


def port_named(params, batch_stats, agg_mode="adaptive", **config):
    """Flax variable trees (``params`` may be a gradient tree of the same
    structure) of a model of this configuration (``config``: any
    ``CascadeMVSNet`` fields; those of the weight table are read) -> {the
    port's state_dict name: numpy array}, through the port's weight bridge
    ``state_dict_from_flax``. JAX is imported here, not at the top: the
    card's test run imports this module without it."""
    import jax
    from damvsnet_tpu_torch.utils.weights import state_dict_from_flax

    table = {k: v for k, v in config.items() if k in TABLE_KEYS}

    flat = {}
    for coll, tree in (("params", params), ("batch_stats", batch_stats)):
        for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = "/".join(str(getattr(k, "key", k)) for k in kp)
            flat[f"{coll}/{key}"] = np.asarray(v, np.float32)
    return {k: v.numpy() for k, v in state_dict_from_flax(flat, agg_mode, **table).items()}


def _flag_values(action):
    """Argument lists that exercise one flag of a parser: each choice, the
    flag alone for a switch, else one value of its type."""
    if action.choices:
        return [[action.option_strings[0], c] for c in action.choices]
    if action.nargs == 0:
        return [[action.option_strings[0]]]
    value = {int: "3", float: "0.5"}.get(action.type, "x")
    return [[action.option_strings[0], value]]


def jax_flags_parse_alike(jax_parser, port_parser, required=()):
    """Every flag of the JAX parser is a flag of the port's with the same
    dest, default, choices, type and arity, and each of its values (see
    ``_flag_values``) parses in both to the same namespace on the JAX
    parser's keys. ``required``: the arguments both parsers require."""
    port_actions = {a.dest: a for a in port_parser._actions if a.option_strings}
    jax_actions = [a for a in jax_parser._actions if a.option_strings and a.dest != "help"]
    assert len(jax_actions) > 20
    for a in jax_actions:
        ours = port_actions.get(a.dest)
        assert ours is not None, f"{a.option_strings} is not a flag of the port's CLI"
        for attr in ("option_strings", "default", "choices", "type", "nargs", "const"):
            assert getattr(ours, attr) == getattr(a, attr), f"{a.dest}: {attr}"
        for argv in _flag_values(a):
            want = vars(jax_parser.parse_args(list(required) + argv))
            got = vars(port_parser.parse_args(list(required) + argv))
            assert {k: got[k] for k in want} == want, argv


def cascade_batch(seed, batch=1, num_views=3, height=32, width=32, ndepth=16):
    """A serving batch of numpy arrays for the tiny cascade (``make_rig``'s
    rig, per-stage intrinsics, random images, a uniform [4, 8] sweep)."""
    rs = np.random.default_rng(seed)
    _, projs = make_rig(batch=batch, num_views=num_views, height=height // 4,
                        width=width // 4, seed=seed)
    proj_ms = {}
    for s in range(1, 4):
        p = projs.copy()
        p[:, :, 1, :2, :] *= 2.0 ** (s - 1)
        proj_ms[f"stage{s}"] = p
    imgs = rs.random((batch, num_views, height, width, 3)).astype(np.float32)
    depth_values = np.linspace(4.0, 8.0, ndepth, dtype=np.float32)[None].repeat(batch, 0)
    return {"imgs": imgs, "proj_matrices": proj_ms, "depth_values": depth_values}


def perturbed_flat(variables, seed=1):
    """Flax variables -> flat-path numpy weights ("params/...",
    "batch_stats/..."), with BN running statistics moved off (0, 1) so the
    BN fold is exercised."""
    import jax

    rs = np.random.default_rng(seed)
    flat = {}
    for kp, v in jax.tree_util.tree_flatten_with_path(variables)[0]:
        key = "/".join(str(getattr(k, "key", k)) for k in kp)
        v = np.asarray(v, np.float32)
        if key.endswith("/mean"):
            v = v + 0.05 * rs.standard_normal(v.shape).astype(np.float32)
        elif key.endswith("/var"):
            v = v * (1.0 + 0.2 * rs.random(v.shape)).astype(np.float32)
        flat[key] = v
    return flat


def port_flax_flat(port, rows, seed=0):
    """A port module's weights, its BN running statistics first moved off
    (0, 1) in place, as flat-path flax variables ("params/...",
    "batch_stats/...") through the weight bridge's table ``rows`` read
    backwards: the JAX side then needs no init of its own (a flax init
    compiles the module once more)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, buf in port.named_buffers():
            if name.endswith("running_mean"):
                buf.add_(0.05 * torch.randn(buf.shape, generator=gen))
            elif name.endswith("running_var"):
                buf.mul_(1.0 + 0.2 * torch.rand(buf.shape, generator=gen))
    sd = port.state_dict()
    flat = {}
    for tkey, fkey, perm in rows:
        if fkey is not None:
            a = sd[tkey].numpy().copy()  # the port updates its buffers in place
            flat[fkey] = a if perm is None else a.transpose(np.argsort(perm))
    return flat


def unflat(flat):
    """Flat-path weights -> the nested flax variables (jnp arrays)."""
    import jax.numpy as jnp

    tree = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


# ---- the whole training step, JAX against the port (fp32, CPU) ----


@contextlib.contextmanager
def flax_two_pass_variance():
    """flax's BatchNorm batch variance computed two-pass, as torch's and the
    port's is: flax's default one-pass E[x^2] - E[x]^2 loses digits to
    cancellation, enough to move a step's losses by more than 1e-5."""
    import flax.linen.normalization as flax_norm

    compute_stats = flax_norm._compute_stats

    def two_pass(*args, **kwargs):
        kwargs["use_fast_variance"] = False
        return compute_stats(*args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax_norm, "_compute_stats", two_pass)
        yield


def synthetic_train_batch(scenes, size=32, nviews=3, d0=16):
    """The JAX package's synthetic scenes, collated: the model's and the
    loss's arrays."""
    from damvsnet_tpu.data.common import collate
    from damvsnet_tpu.data.synthetic import make_synthetic_sample

    batch = collate([make_synthetic_sample(size, size, nviews, d0, seed=s) for s in scenes])
    return {k: batch[k] for k in ("imgs", "proj_matrices", "depth_values", "depth", "mask")}


def checkpoint_trees(agg_mode="adaptive", extra_flat=None):
    """The trained checkpoint as flax (params, batch_stats) trees of a model
    with this aggregation (a variance model has no weight nets), with the
    flat-path arrays ``extra_flat`` (a seeded module the checkpoint lacks)
    added."""
    with np.load(TRAIN_WEIGHTS) as npz:
        flat = {k: npz[k] for k in npz.files
                if agg_mode == "adaptive" or "/agg_weight_stage" not in k}
    flat.update(extra_flat or {})
    trees = {"params": {}, "batch_stats": {}}
    for key, v in flat.items():
        coll, *path, leaf = key.split("/")
        node = trees[coll]
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(v, np.float32)
    return trees["params"], trees["batch_stats"]


def jax_train_step(batch, ndepths, extra_flat=None, **config):
    """``jax.value_and_grad`` of ``cas_mvsnet_loss(use_cpc=True)`` under
    ``train=True, mutable=["batch_stats"]`` for ``CascadeMVSNet(ndepths,
    **config)`` on the trained checkpoint (plus ``extra_flat``), with flax's
    batch variance two-pass: (params, stats, {"losses": [total, depth,
    cpc], "grads", "stats": the updated statistics and the params, by port
    name})."""
    import jax
    import jax.numpy as jnp
    from damvsnet_tpu.losses import cas_mvsnet_loss
    from damvsnet_tpu.model import CascadeMVSNet

    agg_mode = config.get("agg_mode", "adaptive")
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    params, stats = checkpoint_trees(agg_mode, extra_flat)
    if not config.get("use_geo_fusion", True):
        params.pop("geo_fusion"), stats.pop("geo_fusion")
    model = CascadeMVSNet(ndepths=ndepths, **config)

    def loss_fn(params, stats):
        out, mutated = model.apply(
            {"params": params, "batch_stats": stats}, jb["imgs"], jb["proj_matrices"],
            jb["depth_values"], train=True, mutable=["batch_stats"])
        total, depth_loss, cpc = cas_mvsnet_loss(out, jb["imgs"], jb["proj_matrices"],
                                                 jb["depth"], jb["mask"], use_cpc=True)
        return total, (depth_loss, cpc, mutated["batch_stats"])

    with flax_two_pass_variance():
        (total, (depth_loss, cpc, new_stats)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(params, stats)
    want = {"losses": np.array([total, depth_loss, cpc], np.float32),
            "grads": port_named(grads, stats, **config),
            "stats": port_named(params, new_stats, **config)}
    return params, stats, want


def port_train_step(batch, params, stats, ndepths, **config):
    """The port's step on the same weights and inputs: ``model.train()``,
    the forward, the loss, ``backward()`` (on CPU tensors, with no kernel
    launched). Returns {"losses", "model", "before": the state_dict before
    the step, "min_sigma": the smallest 3-sigma band of any stage}."""
    import torch
    from damvsnet_tpu_torch.losses import cas_mvsnet_loss
    from damvsnet_tpu_torch.model import CascadeMVSNet
    from damvsnet_tpu_torch.ops.kernels import fused_costvol, probstats, sweep_sampler
    from damvsnet_tpu_torch.utils.weights import model_config

    model = CascadeMVSNet(ndepths=ndepths, device="cpu", **config)
    model.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in
                           port_named(params, stats, **model_config(model)).items()})
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tb = {k: ({s: torch.from_numpy(a) for s, a in v.items()} if isinstance(v, dict)
              else torch.from_numpy(v)) for k, v in batch.items()}
    counters = (fused_costvol.fused_adaptive_cost_volume,
                fused_costvol.fused_adaptive_cost_volume_backward,
                probstats.prob_volume_stats_fused, sweep_sampler.plane_sweep_sample,
                sweep_sampler.plane_sweep_variance)
    counts = [fn.launches for fn in counters]
    model.train()
    # oneDNN's CPU convolution backward corrupts the heap at these shapes
    # (a segfault at stage 3); torch's own CPU convolutions are used instead
    with torch.backends.mkldnn.flags(enabled=False):
        out = model(tb["imgs"], tb["proj_matrices"], tb["depth_values"])
        losses = cas_mvsnet_loss(out, tb["imgs"], tb["proj_matrices"], tb["depth"],
                                 tb["mask"], use_cpc=True)
        losses[0].backward()
    assert counts == [fn.launches for fn in counters]
    min_sigma = min(float(out[f"stage{s}"]["variance"].detach().min()) for s in (1, 2, 3))
    return {"losses": np.array([float(x.detach()) for x in losses], np.float32),
            "model": model, "before": before, "min_sigma": min_sigma}


def assert_gradients_match(want, got, group=lambda name: name):
    """Every parameter's gradient finite and within 1e-3 of the largest JAX
    entry of its group (+1e-7), matched by name through the bridge. A
    tensor is its own group unless ``group`` maps names together."""
    scale = {}
    for name, ref in want["grads"].items():
        scale[group(name)] = max(scale.get(group(name), 0.0), float(np.abs(ref).max()))
    bad = []
    named = dict(got["model"].named_parameters())
    assert set(named) <= set(want["grads"])
    for name, p in named.items():
        assert p.grad is not None, name
        g = p.grad.numpy()
        assert np.isfinite(g).all(), name
        tol = 1e-3 * scale[group(name)] + 1e-7
        err = np.abs(g - want["grads"][name]).max()
        if err > tol:
            bad.append(f"{name}: {err:.3g} > {tol:.3g}")
    assert not bad, bad


def assert_running_statistics_match(want, got):
    """Every running mean and variance at 1e-5."""
    sd = got["model"].state_dict()
    names = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert names
    for name in names:
        np.testing.assert_allclose(sd[name].numpy(), want["stats"][name],
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def assert_step_matches_by_l2(want, got, loss_rtol=1e-4, grad_l2=1e-2):
    """The losses at ``loss_rtol`` and the whole gradient, every parameter's
    flattened together, within ``grad_l2`` relative L2 of JAX's: the limits
    chip_smoke.py holds the card's steps to, for steps whose per-tensor
    gradient is not held (a rounding that crosses a ReLU kink moves a few
    tensors by percents)."""
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=loss_rtol,
                               err_msg="total, depth, cpc")
    named = dict(got["model"].named_parameters())
    assert set(named) <= set(want["grads"])
    g = np.concatenate([p.grad.numpy().ravel() for p in named.values()])
    w = np.concatenate([want["grads"][k].ravel() for k in named])
    assert np.isfinite(g).all()
    rel = np.linalg.norm(g - w) / np.linalg.norm(w)
    assert rel <= grad_l2, rel
