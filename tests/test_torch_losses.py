"""The port's training losses against the JAX package's on the same numpy
inputs, in fp32 on the CPU, at 1e-5: the staged smooth-L1 + CPC loss
(values and the gradient with respect to the depth maps), the cross-view
loss, ``inverse_warping`` (including the reference's y1-mask quirk on the
bottom row) and ``resize_bilinear(align_corners=True)``, the CPC loss's
image resize."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _example_batch
from damvsnet_tpu.losses import crossview as jcv
from damvsnet_tpu.losses import supervised as jsup
from damvsnet_tpu.ops.resize import resize_bilinear as jresize
from damvsnet_tpu_torch.losses import crossview as tcv
from damvsnet_tpu_torch.losses import supervised as tsup
from damvsnet_tpu_torch.ops.resize import resize_bilinear

torch.set_num_threads(1)

STAGES = ("stage1", "stage2", "stage3")


@pytest.fixture(scope="module")
def batch():
    """_example_batch's inputs as numpy, with depth estimates near the
    ground truth and a mask with holes."""
    b = jax.tree_util.tree_map(np.array, _example_batch(batch=2, nviews=3, height=32,
                                                        width=32, d0=16))
    rs = np.random.default_rng(3)
    b["est"] = {s: (b["depth"][s] + 0.4 * rs.standard_normal(b["depth"][s].shape))
                .astype(np.float32) for s in STAGES}
    b["mask"] = {s: (rs.random(m.shape) > 0.2).astype(np.float32)
                 for s, m in b["mask"].items()}
    return b


def _t(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("use_cpc", [True, False])
def test_cas_mvsnet_loss_and_depth_gradient(batch, use_cpc):
    def jf(est):
        total, dl, cpc = jsup.cas_mvsnet_loss(
            {s: {"depth": est[s]} for s in STAGES}, _j(batch["imgs"]),
            _j(batch["proj_matrices"]), _j(batch["depth"]), _j(batch["mask"]),
            use_cpc=use_cpc)
        return total, (dl, cpc)

    (jtotal, (jdl, jcpc)), jgrad = jax.value_and_grad(jf, has_aux=True)(_j(batch["est"]))
    est = {s: torch.from_numpy(batch["est"][s].copy()).requires_grad_() for s in STAGES}
    total, dl, cpc = tsup.cas_mvsnet_loss(
        {s: {"depth": est[s]} for s in STAGES}, _t(batch["imgs"]),
        _t(batch["proj_matrices"]), _t(batch["depth"]), _t(batch["mask"]),
        use_cpc=use_cpc)
    total.backward()
    np.testing.assert_allclose([float(x.detach()) for x in (total, dl, cpc)],
                               [float(jtotal), float(jdl), float(jcpc)], rtol=1e-5)
    for s in STAGES:
        g = np.asarray(jgrad[s])
        np.testing.assert_allclose(est[s].grad.numpy(), g, rtol=1e-5,
                                   atol=1e-5 * np.abs(g).max(), err_msg=s)


def test_cross_view_loss(batch):
    want = jcv.cross_view_loss({s: {"depth": jnp.asarray(batch["est"][s])} for s in STAGES},
                               _j(batch["imgs"]), _j(batch["proj_matrices"]),
                               _j(batch["depth"]), (0.5, 1.0, 2.0))
    got = tcv.cross_view_loss({s: {"depth": torch.from_numpy(batch["est"][s])} for s in STAGES},
                              _t(batch["imgs"]), _t(batch["proj_matrices"]),
                              _t(batch["depth"]), (0.5, 1.0, 2.0))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("stage", STAGES)
def test_inverse_warping(batch, stage):
    cams = batch["proj_matrices"][stage]
    h, w = batch["est"][stage].shape[1:]
    img = jax.image.resize(jnp.asarray(batch["imgs"][:, 1]), (2, h, w, 3), "linear")
    img = np.array(img)
    jw, jm = jcv.inverse_warping(jnp.asarray(img), jnp.asarray(cams[:, 0]),
                                 jnp.asarray(cams[:, 1]), jnp.asarray(batch["est"][stage]))
    tw, tm = tcv.inverse_warping(torch.from_numpy(img), torch.from_numpy(cams[:, 0]),
                                 torch.from_numpy(cams[:, 1]),
                                 torch.from_numpy(batch["est"][stage]))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-5)


def test_inverse_warping_bottom_row_quirk():
    """A source camera shifted so every pixel lands 0.25 px below and
    0.3 px right of itself: on the bottom row y0 = H-1 is in the image but
    y1 = H is not, and the reference's mask (which tests y0 twice) still
    calls the pixel valid, sampling the clamped row."""
    b, h, w, depth = 1, 8, 12, 5.0
    f = 10.0
    k = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    left = np.zeros((b, 2, 4, 4), np.float32)
    left[:, 0] = np.eye(4)
    left[:, 1, :3, :3] = k
    right = left.copy()
    right[:, 0, 0, 3] = 0.3 * depth / f
    right[:, 0, 1, 3] = 0.25 * depth / f
    rs = np.random.default_rng(0)
    img = rs.random((b, h, w, 3)).astype(np.float32)
    dmap = np.full((b, h, w), depth, np.float32)
    jw, jm = jcv.inverse_warping(*(jnp.asarray(a) for a in (img, left, right, dmap)))
    tw, tm = tcv.inverse_warping(*(torch.from_numpy(a) for a in (img, left, right, dmap)))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-5)
    mask = tm.numpy()[0, :, :, 0]
    assert mask[h - 1, : w - 1].all()      # the quirk: y1 = H goes unchecked
    assert not mask[:, w - 1].any()        # x1 = W is checked
    # the bottom row samples rows H-1 and the clamped H-1: only x blends
    want = 0.7 * img[0, h - 1, :w - 2] + 0.3 * img[0, h - 1, 1:w - 1]
    np.testing.assert_allclose(tw.numpy()[0, h - 1, :w - 2], want, atol=1e-5)


@pytest.mark.parametrize("out_hw", [(8, 8), (16, 12), (37, 23)])
def test_resize_bilinear_align_corners(out_hw):
    x = np.random.default_rng(1).random((2, 32, 24, 3)).astype(np.float32)
    want = np.asarray(jresize(jnp.asarray(x), out_hw, align_corners=True))
    got = resize_bilinear(torch.from_numpy(x), out_hw, align_corners=True).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
