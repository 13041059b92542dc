"""The port's losses against the JAX package's on the same numpy inputs,
in fp32 on the CPU, at 1e-5: the staged smooth-L1 + CPC loss (values and
the gradient with respect to the depth maps), the cross-view loss,
``inverse_warping`` (including the reference's y1-mask quirk on the bottom
row) and ``resize_bilinear(align_corners=True)``, the CPC loss's image
resize; and the library losses no train step calls: the entropy family
(info-entropy, entropy with its winner-take-all depth, the staged focal
loss with BlendedMVS's metrics) and the unsupervised ones (SSIM,
smoothness, reconstruction, the staged unsupervised loss, with the
gradient with respect to the depth maps)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _example_batch
from damvsnet_tpu.losses import crossview as jcv
from damvsnet_tpu.losses import entropy as jent
from damvsnet_tpu.losses import supervised as jsup
from damvsnet_tpu.losses import unsupervised as junsup
from damvsnet_tpu.ops.resize import resize_bilinear as jresize
from damvsnet_tpu_torch.losses import crossview as tcv
from damvsnet_tpu_torch.losses import entropy as tent
from damvsnet_tpu_torch.losses import supervised as tsup
from damvsnet_tpu_torch.losses import unsupervised as tunsup
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


@pytest.fixture(scope="module")
def prob_outputs(batch):
    """Per stage, a pre-softmax volume, its softmax, per-pixel sorted
    hypotheses around the ground truth and the soft-argmin depth (numpy)."""
    rs = np.random.default_rng(5)
    out = {}
    for s, d in zip(STAGES, (16, 8, 8)):
        gt = batch["depth"][s]
        pre = (2 * rs.standard_normal((gt.shape[0], d) + gt.shape[1:])).astype(np.float32)
        prob = np.exp(pre - pre.max(1, keepdims=True))
        prob = (prob / prob.sum(1, keepdims=True)).astype(np.float32)
        dv = np.sort(gt[:, None] + rs.uniform(-1.0, 1.0, prob.shape), axis=1).astype(np.float32)
        out[s] = {"prob_volume_pre": pre, "prob_volume": prob, "depth_values": dv,
                  "depth": (prob * dv).sum(1).astype(np.float32)}
    return out


def test_entropy_losses(batch, prob_outputs):
    for s in STAGES:
        o, gt, mask = prob_outputs[s], batch["depth"][s], batch["mask"][s]
        want = jent.info_entropy_loss(jnp.asarray(o["prob_volume"]),
                                      jnp.asarray(o["prob_volume_pre"]), jnp.asarray(mask))
        got = tent.info_entropy_loss(torch.from_numpy(o["prob_volume"]),
                                     torch.from_numpy(o["prob_volume_pre"]),
                                     torch.from_numpy(mask))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5, err_msg=s)
        for dv in (o["depth_values"], o["depth_values"][:, :, 0, 0]):  # per pixel, per batch
            jce, jwta = jent.entropy_loss(*(jnp.asarray(a) for a in
                                            (o["prob_volume"], gt, mask, dv)))
            ce, wta = tent.entropy_loss(*(torch.from_numpy(a) for a in
                                          (o["prob_volume"], gt, mask, dv)))
            np.testing.assert_allclose(float(ce), float(jce), rtol=1e-5, err_msg=s)
            np.testing.assert_array_equal(wta.numpy(), np.asarray(jwta))


def test_focal_loss_bld(batch, prob_outputs):
    want = jent.focal_loss_bld(_j(prob_outputs), _j(batch["depth"]), _j(batch["mask"]), 2.65)
    got = tent.focal_loss_bld(_t(prob_outputs), _t(batch["depth"]), _t(batch["mask"]), 2.65)
    np.testing.assert_allclose([float(x) for x in got], [float(x) for x in want], rtol=1e-5,
                               err_msg="total, depth loss, epe, less1, less3")


def test_ssim_and_smoothness(batch):
    x = batch["imgs"][:, 0]
    y = np.clip(batch["imgs"][:, 1] + 0.05, 0, 1)
    want = np.asarray(junsup.ssim(jnp.asarray(x), jnp.asarray(y)))
    got = tunsup.ssim(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert got.shape == (2, 30, 30, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)
    for s in STAGES:
        d = batch["est"][s]
        img = np.array(jresize(jnp.asarray(x), d.shape[1:], align_corners=True))
        want = junsup.depth_smoothness(jnp.asarray(d), jnp.asarray(img), weight=0.5)
        got = tunsup.depth_smoothness(torch.from_numpy(d), torch.from_numpy(img), weight=0.5)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5, err_msg=s)


def test_unsupervised_losses_and_depth_gradient(batch):
    s = "stage2"
    want = junsup.unsup_reconstruction_loss(jnp.asarray(batch["est"][s]), _j(batch["imgs"]),
                                            jnp.asarray(batch["proj_matrices"][s]), top_k=1)
    got = tunsup.unsup_reconstruction_loss(torch.from_numpy(batch["est"][s]), _t(batch["imgs"]),
                                           torch.from_numpy(batch["proj_matrices"][s]), top_k=1)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)

    def jf(est):
        return junsup.unsup_loss({k: {"depth": est[k]} for k in STAGES}, _j(batch["imgs"]),
                                 _j(batch["proj_matrices"]))

    (jtotal, jlast), jgrad = jax.value_and_grad(jf, has_aux=True)(_j(batch["est"]))
    est = {k: torch.from_numpy(batch["est"][k].copy()).requires_grad_() for k in STAGES}
    total, last = tunsup.unsup_loss({k: {"depth": est[k]} for k in STAGES}, _t(batch["imgs"]),
                                    _t(batch["proj_matrices"]))
    total.backward()
    np.testing.assert_allclose([float(total.detach()), float(last.detach())],
                               [float(jtotal), float(jlast)], rtol=1e-5)
    for k in STAGES:
        g = np.asarray(jgrad[k])
        np.testing.assert_allclose(est[k].grad.numpy(), g, rtol=1e-5,
                                   atol=1e-5 * np.abs(g).max(), err_msg=k)
