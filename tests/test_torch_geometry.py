"""The kernels' batched per-view geometry (``ops.warp.geoms_from_projs``:
one inverse of the reference projection, one fp32 product over the stacked
source projections) against the per-view ``geom_from_projs`` of the port and
of the JAX package (``damvsnet_tpu/ops/pallas/sweep_sampler.py``), on the
same numpy cameras.

Tolerance 1e-6 of the largest entry: the port's two forms run the same fp32
operations, and JAX inverts and multiplies (at HIGHEST precision) in
another order.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from damvsnet_tpu.ops.pallas.sweep_sampler import geom_from_projs as jgeom
from damvsnet_tpu_torch.data.synthetic import make_synthetic_sample
from damvsnet_tpu_torch.model.cascade import fuse_projection_matrices
from damvsnet_tpu_torch.ops import warp
from damvsnet_tpu_torch.ops.kernels._common import check_plane
from torch_helpers import fused_projs

torch.set_num_threads(1)


def _compare(ref_p, src_ps):
    got = warp.geoms_from_projs([torch.from_numpy(p) for p in src_ps],
                                torch.from_numpy(ref_p))
    assert got.shape == (len(src_ps), ref_p.shape[0], 12) and got.dtype == torch.float32
    per_view = torch.stack([warp.geom_from_projs(torch.from_numpy(p), torch.from_numpy(ref_p))
                            for p in src_ps])
    want = np.stack([np.asarray(jgeom(jnp.asarray(p), jnp.asarray(ref_p))) for p in src_ps])
    tol = 1e-6 * float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), per_view.numpy(), rtol=0, atol=tol)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("batch,views", [(1, 1), (2, 4), (1, 16)])
def test_batched_geometry_matches_per_view(batch, views):
    projs = fused_projs(batch, views + 1, 24, 32, seed=batch + views)
    _compare(projs[0], projs[1:])


def test_batched_geometry_on_the_synthetic_scene():
    """The cameras of the synthetic scene at the training width, stage 3."""
    sample = make_synthetic_sample(height=64, width=80, nviews=5, ndepths=16, seed=1)
    proj = torch.from_numpy(sample["proj_matrices"]["stage3"][None])
    fused = fuse_projection_matrices(proj).numpy()
    _compare(fused[:, 0], [fused[:, v] for v in range(1, 5)])


def test_check_plane_limits_32_bit_offsets():
    check_plane("k", 864, 1152, 32)
    with pytest.raises(ValueError, match="2\\^31"):
        check_plane("k", 2 ** 14, 2 ** 12, 32)
