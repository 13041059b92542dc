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
