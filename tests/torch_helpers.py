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
