"""Inputs shared by the PyTorch port's tests (a helper module, not a test
file: pytest collects nothing here)."""
import numpy as np

from conftest import make_rig


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


def port_named(params, batch_stats):
    """Flax variable trees (``params`` may be a gradient tree of the same
    structure) -> {the port's state_dict name: numpy array}, through the
    port's weight bridge ``state_dict_from_flax``. JAX is imported here,
    not at the top: the card's test run imports this module without it."""
    import jax
    from damvsnet_tpu_torch.utils.weights import state_dict_from_flax

    flat = {}
    for coll, tree in (("params", params), ("batch_stats", batch_stats)):
        for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = "/".join(str(getattr(k, "key", k)) for k in kp)
            flat[f"{coll}/{key}"] = np.asarray(v, np.float32)
    return {k: v.numpy() for k, v in state_dict_from_flax(flat).items()}


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
