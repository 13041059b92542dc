"""The port's learning-rate schedule, optimizers and metrics against the
JAX package's (damvsnet_tpu/train/schedule.py, train/metrics.py and
optax's adam/adamw) on the same inputs."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from damvsnet_tpu.train import metrics as jmetrics
from damvsnet_tpu.train import schedule as jschedule
from damvsnet_tpu_torch.train import metrics as tmetrics
from damvsnet_tpu_torch.train import schedule as tschedule

torch.set_num_threads(1)


@pytest.mark.parametrize("spec", ["10,12,14:2", "3,5:10", ":2"])
def test_parse_lr_epochs(spec):
    assert tschedule.parse_lr_epochs(spec) == jschedule.parse_lr_epochs(spec)


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_schedule_matches_optax_schedule(wd):
    """The LambdaLR's lr at each update against the JAX schedule's value at
    the same optax step: warmup, plateau and every milestone."""
    iters, base = 40, 1e-3
    _, jsched = jschedule.make_optimizer(base, "10,12,14:2", iters, wd)
    p = torch.nn.Parameter(torch.zeros(3))
    opt, sched = tschedule.make_optimizer([p], base, "10,12,14:2", iters, wd)
    steps = [0, 1, 250, 499, 500, 501, 399, 400, 479, 480, 481, 560, 700]
    lrs = {}
    for step in range(max(steps) + 1):
        lrs[step] = opt.param_groups[0]["lr"]
        opt.step()
        sched.step()
    for step in steps:
        np.testing.assert_allclose(lrs[step], float(jsched(step)), rtol=1e-6,
                                   err_msg=f"step {step}")


@pytest.mark.parametrize("warmup_iters", [100, 1])
def test_warmup_iters_matches_jax_at_every_step(warmup_iters):
    """``make_optimizer(..., warmup_iters=)`` against JAX's at every step of
    a short run: the warmup, then two milestones ("3,4:2" of 40 steps an
    epoch: steps 120 and 160), as scripts/e2e_synthetic_torch.py builds it."""
    iters, base = 40, 1e-3
    _, jsched = jschedule.make_optimizer(base, "3,4:2", iters, 0.0, warmup_iters=warmup_iters)
    p = torch.nn.Parameter(torch.zeros(3))
    opt, sched = tschedule.make_optimizer([p], base, "3,4:2", iters, 0.0,
                                          warmup_iters=warmup_iters)
    got, want = [], []
    for step in range(200):
        got.append(opt.param_groups[0]["lr"])
        want.append(float(jsched(step)))
        opt.step()
        sched.step()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[warmup_iters] == pytest.approx(base) and got[199] == pytest.approx(base / 4)


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_one_update_matches_optax(wd):
    """One and then a second update of a toy tensor: Adam (betas 0.9/0.999,
    eps 1e-8) or AdamW, against optax's adam/adamw at the same lr."""
    rs = np.random.default_rng(0)
    x0 = rs.standard_normal((4, 5)).astype(np.float32)
    grads = [rs.standard_normal((4, 5)).astype(np.float32) for _ in range(2)]
    lr = 3e-3
    tx = optax.adamw(lr, weight_decay=wd) if wd else optax.adam(lr)
    jp = jnp.asarray(x0)
    state = tx.init(jp)
    p = torch.nn.Parameter(torch.from_numpy(x0.copy()))
    cls = torch.optim.AdamW if wd else torch.optim.Adam
    opt = cls([p], lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=wd)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        p.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-6)
    opt2, _ = tschedule.make_optimizer([torch.nn.Parameter(torch.zeros(1))], lr,
                                       "10:2", 10, wd)
    assert type(opt2) is cls


@pytest.fixture(scope="module")
def depth_maps():
    rs = np.random.default_rng(2)
    gt = (5 + rs.random((3, 16, 20))).astype(np.float32)
    est = (gt + rs.standard_normal(gt.shape) * 4).astype(np.float32)
    mask = rs.random(gt.shape) > 0.3
    mask[2] = False  # an image with no valid pixel
    return est, gt, mask


@pytest.mark.parametrize("thres", [0.5, 2.0, 4.0, 8.0])
def test_thres_metrics(depth_maps, thres):
    est, gt, mask = depth_maps
    want = jmetrics.thres_metrics(jnp.asarray(est), jnp.asarray(gt), jnp.asarray(mask), thres)
    got = tmetrics.thres_metrics(torch.from_numpy(est), torch.from_numpy(gt),
                                 torch.from_numpy(mask), thres)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("band", [None, (0.0, 2.0), (2.0, 4.0), (4.0, 8.0), (20.0, 1e5)])
def test_abs_depth_error_metrics(depth_maps, band):
    est, gt, mask = depth_maps
    want = jmetrics.abs_depth_error_metrics(jnp.asarray(est), jnp.asarray(gt),
                                            jnp.asarray(mask), band)
    got = tmetrics.abs_depth_error_metrics(torch.from_numpy(est), torch.from_numpy(gt),
                                           torch.from_numpy(mask), band)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_dict_average_meter():
    rows = [{"a": 1.0, "b": 2.0}, {"a": torch.tensor(3.0), "b": np.float32(6.0)}]
    jm, tm = jmetrics.DictAverageMeter(), tmetrics.DictAverageMeter()
    for r in rows:
        jm.update({k: float(v) for k, v in r.items()})
        tm.update(r)
    assert tm.mean() == jm.mean() == {"a": 2.0, "b": 4.0}
