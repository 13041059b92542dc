"""The port's Trainer, checkpoints, data loader and training CLI on the CPU
(tiny cascade: ndepths (8, 8, 8), synthetic scenes at 32x32, N=3; the
Trainer's tests train the fused configuration, the CLI's each one it
builds, DTU's loader included on a fake tree)."""
import functools
import os

import numpy as np
import pytest
import torch

from damvsnet_tpu.cli import train as jax_cli_train
from damvsnet_tpu_torch import data as port_data
from damvsnet_tpu_torch.cli import train as cli_train
from damvsnet_tpu_torch.data import DataLoader, DTUTrainDataset, SyntheticDataset
from damvsnet_tpu_torch.losses import cas_mvsnet_loss
from damvsnet_tpu_torch.model import CascadeMVSNet
from damvsnet_tpu_torch.train.loop import Trainer, batch_to_device, make_train_step
from damvsnet_tpu_torch.train.schedule import make_optimizer
from damvsnet_tpu_torch.train.state import (Checkpointer, TrainState, latest_checkpoint,
                                            restore_checkpoint)
from test_data import fake_dtu  # noqa: F401  (the JAX data tests' DTU tree)
from torch_helpers import jax_flags_parse_alike

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def no_onednn():
    """Torch's own CPU convolutions: oneDNN's convolution backward has
    corrupted the heap at some of the cascade's training shapes."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _loader(length=4, shuffle=False):
    ds = SyntheticDataset(height=32, width=32, nviews=3, ndepths=16, length=length)
    return DataLoader(ds, batch_size=2, shuffle=shuffle, seed=0, num_workers=0)


def _state(seed=0):
    torch.manual_seed(seed)
    model = CascadeMVSNet(ndepths=(8, 8, 8), device="cpu", fused_train=True)
    opt, sched = make_optimizer(model.parameters(), 1e-3, "10,12,14:2", iters_per_epoch=4)
    return TrainState(model, opt, sched)


def _snapshot(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def test_trainer_two_steps_move_the_parameters(tmp_path):
    state = _state()
    before = _snapshot(state.model)
    logs = []
    trainer = Trainer(state, str(tmp_path), summary_freq=1, log_fn=logs.append,
                      device="cpu")
    means = trainer.train_epoch(_loader().iter_epoch(0))
    assert state.step == 2 and state.epoch == 1
    assert np.isfinite(list(means.values())).all()
    assert {"loss", "depth_loss", "cpc_loss", "abs_depth_error"} <= set(means)
    after = state.model.state_dict()
    moved = [k for k, p in state.model.named_parameters()
             if not torch.equal(p.detach(), before[k])]
    assert len(moved) > 0.9 * len(list(state.model.parameters()))
    assert not torch.equal(after["feature.conv0.0.bn.running_mean"],
                           before["feature.conv0.0.bn.running_mean"])
    assert len(logs) == 2
    assert os.path.exists(tmp_path / "ckpt_000001.pt")
    evals = trainer.eval_epoch(_loader().iter_epoch(0))
    assert "thres2mm_error" in evals and "abserr_0mm_2.0mm" in evals


def test_grad_accum_averages_microbatch_gradients():
    """grad_accum=2 splits a batch of 4 into two microbatches of 2, each its
    own training forward (its own batch statistics), and makes one update
    from the mean of their gradients."""
    ds = SyntheticDataset(height=32, width=32, nviews=3, ndepths=16, length=4)
    batch = next(DataLoader(ds, batch_size=4, num_workers=0).iter_epoch(0))
    halves = [{k: ({s: a[i:i + 2] for s, a in v.items()} if isinstance(v, dict)
                   else v[i:i + 2]) for k, v in batch.items()} for i in (0, 2)]
    state, ref = _state(), _state()
    make_train_step(grad_accum=2, device="cpu")(state, batch)
    assert state.step == 1

    ref.model.train()
    ref.optimizer.zero_grad()
    for half in halves:
        mb = batch_to_device(half, "cpu")
        out = ref.model(mb["imgs"], mb["proj_matrices"], mb["depth_values"])
        total = cas_mvsnet_loss(out, mb["imgs"], mb["proj_matrices"], mb["depth"],
                                mb["mask"])[0]
        (total / 2).backward()
    ref.optimizer.step()
    for (k, p), q in zip(state.model.named_parameters(), ref.model.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=k)


def test_mid_epoch_resume_is_bit_identical(tmp_path):
    """A run killed after 2 of 4 batches resumes from its mid-epoch
    checkpoint (with the data cursor) and ends bit-identical to an
    uninterrupted run over the same (shuffled) batch order."""
    loader = _loader(length=8, shuffle=True)
    step = make_train_step(device="cpu")

    ref = _state()
    init = _snapshot(ref.model)
    for batch in loader.iter_epoch(1):
        step(ref, batch)

    run = _state()
    saves = Checkpointer(str(tmp_path))
    for i, batch in enumerate(loader.iter_epoch(1)):
        if i == 2:
            break
        step(run, batch)
    run.epoch = 1
    saves.save(run, cursor=2, background=True)
    saves.wait()
    del run

    resumed = _state(seed=1)
    resumed.model.load_state_dict(init)  # a fresh process builds the same model
    ckpt = latest_checkpoint(str(tmp_path))
    assert ckpt and "ckpt_step_" in ckpt
    resumed, cursor = restore_checkpoint(ckpt, resumed)
    assert cursor == 2 and resumed.step == 2 and resumed.epoch == 1
    trainer = Trainer(resumed, str(tmp_path), summary_freq=100, device="cpu")
    trainer.train_epoch(loader.iter_epoch(resumed.epoch, skip=cursor), first_batch=cursor)
    assert resumed.step == ref.step == 4
    for k, v in ref.model.state_dict().items():
        assert torch.equal(v, resumed.model.state_dict()[k]), k
    assert resumed.scheduler.last_epoch == ref.scheduler.last_epoch


def test_latest_checkpoint_prefers_the_newest_save(tmp_path):
    state = _state()
    saves = Checkpointer(str(tmp_path))
    state.step, state.epoch = 5, 0
    saves.save(state, cursor=5)
    state.step, state.epoch = 8, 1
    path_epoch = saves.save(state)
    assert latest_checkpoint(str(tmp_path)) == path_epoch
    state.step = 11
    path_step = saves.save(state, cursor=3)
    assert latest_checkpoint(str(tmp_path)) == path_step
    assert latest_checkpoint(str(tmp_path / "missing")) is None


def test_background_saves_rotate_without_racing(tmp_path):
    state = _state()
    saves = Checkpointer(str(tmp_path), max_keep=2)
    for s in range(1, 6):
        state.step = s
        saves.save(state, cursor=s, background=True)
    saves.wait()
    names = sorted(os.listdir(tmp_path))
    assert names == ["ckpt_step_000000004.pt", "ckpt_step_000000005.pt"]
    restored, cursor = restore_checkpoint(str(tmp_path / names[-1]), _state())
    assert cursor == 5 and restored.step == 5
    weights_only, cursor = restore_checkpoint(str(tmp_path / names[-1]), _state(),
                                              weights_only=True)
    assert cursor == 0 and weights_only.step == 0


def test_loader_order_is_named_by_the_epoch():
    loader = _loader(length=8, shuffle=True)
    files = lambda it: [b["filename"] for b in it]
    e1 = files(loader.iter_epoch(1))
    assert files(loader.iter_epoch(1, skip=2)) == e1[2:]
    assert files(loader.iter_epoch(1)) == e1
    assert files(loader.iter_epoch(0)) != e1
    threaded = DataLoader(loader.dataset, batch_size=2, shuffle=True, seed=0, num_workers=2)
    assert files(threaded.iter_epoch(1, skip=1)) == e1[1:]


@pytest.fixture
def tiny_synthetic(monkeypatch):
    monkeypatch.setitem(port_data._REGISTRY, "synthetic",
                        functools.partial(SyntheticDataset, height=32, width=32, length=4))


_CLI = ["--dataset", "synthetic", "--batch_size", "2", "--nviews", "3",
        "--numdepth", "16", "--ndepths", "8,8,8", "--num_workers", "0",
        "--device", "cpu", "--summary_freq", "1"]


def test_cli_trains_one_epoch_and_resumes(tiny_synthetic, tmp_path):
    logdir = str(tmp_path / "run")
    trainer = cli_train.main(_CLI + ["--epochs", "1", "--logdir", logdir])
    assert trainer.state.step == 2 and trainer.state.epoch == 1
    assert os.path.exists(os.path.join(logdir, "ckpt_000001.pt"))
    resumed = cli_train.main(_CLI + ["--epochs", "2", "--logdir", logdir, "--resume"])
    assert resumed.state.step == 4 and resumed.state.epoch == 2


def test_cli_mesh_space_needs_its_ranks(tiny_synthetic, tmp_path):
    """--mesh_space 2 builds a 1x2 mesh, which one process cannot hold: it
    raises as JAX's make_mesh asserts (tests/test_torch_slab.py trains on
    the 2x2 mesh)."""
    with pytest.raises(ValueError, match="mesh 1x2 != 1 ranks"):
        cli_train.main(_CLI + ["--epochs", "1", "--logdir", str(tmp_path), "--mesh_space", "2"])


def test_cli_share_cr_raises_as_jax_does(tiny_synthetic, tmp_path):
    """One regularizer cannot take the stages' three widths: the port
    refuses --share_cr where the JAX CLI's model fails at init
    (tests/test_torch_variants.py holds JAX's failure)."""
    with pytest.raises(ValueError, match="share_cr: one CostRegNet cannot take"):
        cli_train.main(_CLI + ["--epochs", "1", "--logdir", str(tmp_path), "--share_cr"])


@pytest.mark.parametrize("case", ["defaults", "every_jax_flag"])
def test_cli_defaults_follow_the_jax_cli(case):
    """Every flag both CLIs take has the same default (the dataset
    ``dtu_yao`` and no ``--fused_train`` among them); and every flag of the
    JAX CLI parses in the port's, with its choices and default (``--mode
    test|profile``, ``--cache_dir``, ``--debug_nans`` among them)."""
    if case == "every_jax_flag":
        jax_flags_parse_alike(jax_cli_train.build_parser(), cli_train.build_parser())
        return
    ours = vars(cli_train.build_parser().parse_args([]))
    theirs = vars(jax_cli_train.build_parser().parse_args([]))
    shared = set(ours) & set(theirs)
    assert {"dataset", "fused_train", "agg_mode", "ndepths", "numdepth"} <= shared
    assert {k: ours[k] for k in shared} == {k: theirs[k] for k in shared}
    assert ours["dataset"] == "dtu_yao" and ours["fused_train"] is False


@pytest.mark.parametrize("mode", ["test", "profile"])
def test_cli_mode_is_never_read(tiny_synthetic, tmp_path, mode):
    """``--mode test`` and ``--mode profile`` train as ``--mode train``
    does, as in the JAX CLI, which never reads the flag: the same steps to
    the same parameters."""
    runs = {}
    for m in ("train", mode):
        trainer = cli_train.main(_CLI + ["--epochs", "1", "--logdir", str(tmp_path / m),
                                         "--mode", m])
        assert trainer.state.step == 2
        runs[m] = trainer.state.model.state_dict()
    for k, v in runs["train"].items():
        assert torch.equal(runs[mode][k], v), k


class _NaNBackward(torch.autograd.Function):
    """The identity, whose backward returns NaN."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return torch.full_like(g, float("nan"))


@pytest.mark.parametrize("debug_nans", [False, True])
def test_cli_debug_nans_raises_on_a_nan_backward(monkeypatch, tmp_path, debug_nans):
    """A NaN planted in the loss's backward, in an epoch of one step: with
    ``--debug_nans`` (anomaly detection) the step raises, naming the
    function that returned it; without it the same step runs through and
    its NaN gradients reach the parameters."""
    from damvsnet_tpu_torch.train import loop

    monkeypatch.setitem(port_data._REGISTRY, "synthetic",
                        functools.partial(SyntheticDataset, height=32, width=32, length=2))

    real = loop.cas_mvsnet_loss

    def planted(*args, **kwargs):
        total, depth_loss, cpc = real(*args, **kwargs)
        return _NaNBackward.apply(total), depth_loss, cpc
    monkeypatch.setattr(loop, "cas_mvsnet_loss", planted)
    argv = _CLI + ["--epochs", "1", "--logdir", str(tmp_path)]
    if not debug_nans:
        trainer = cli_train.main(argv)
        assert trainer.state.step == 1
        assert any(p.isnan().any() for p in trainer.state.model.parameters())
        assert not torch.is_anomaly_enabled()
        return
    with pytest.raises(RuntimeError, match="_NaNBackwardBackward.* returned nan"):
        cli_train.main(argv + ["--debug_nans"])
    assert not torch.is_anomaly_enabled()


@pytest.mark.parametrize("flags", [
    ["--no_geo_fusion"], ["--cr_base_chs", "4,8,4"], ["--agg_mode", "variance"],
    ["--fused_train"], ["--dataset", "dtu_yao"], ["--use_fmt"], ["--grad_method", "undetach"],
    ["--use_fmt", "--grad_method", "undetach", "--fused_train"],
], ids=["no_geo_fusion", "cr_base_chs", "variance", "fused_train", "dtu_yao", "use_fmt",
        "undetach", "use_fmt-undetach-fused_train"])
def test_cli_trains_the_variants(monkeypatch, capsys, request, tmp_path, flags):
    """The CLI builds what the JAX CLI builds from the same flags (without
    ``--fused_train`` the non-fused step on unclamped hypotheses, with it
    the fused step on clamped ones; ``--use_fmt`` the FMT pathway,
    ``--grad_method`` the handoff), and each configuration trains: one
    step gives a finite loss and moves the parameters. ``dtu_yao`` reads
    the fake DTU tree, its list trimmed to one batch and its samples cut to
    their top-left 64x96 (a crop from the origin keeps the cameras)."""
    monkeypatch.setitem(port_data._REGISTRY, "synthetic",
                        functools.partial(SyntheticDataset, height=32, width=32, length=2))
    argv = _CLI + ["--epochs", "1", "--logdir", str(tmp_path / "run")] + flags
    if "dtu_yao" in flags:
        root, listfile = request.getfixturevalue("fake_dtu")

        class CroppedDTU(DTUTrainDataset):
            def __getitem__(self, idx):
                s = super().__getitem__(idx)
                s["imgs"] = s["imgs"][:, :64, :96]
                for k in ("depth", "mask"):
                    s[k] = {st: a[:a.shape[0] * 64 // 512, :a.shape[1] * 96 // 640]
                            for st, a in s[k].items()}
                return s

        def two_samples(*args, **kwargs):
            ds = CroppedDTU(*args, **kwargs)
            ds.metas = ds.metas[:2]
            return ds
        monkeypatch.setitem(port_data._REGISTRY, "dtu_yao", two_samples)
        argv += ["--trainpath", str(root), "--trainlist", str(listfile)]
    fused = "--fused_train" in flags
    agg_mode = "variance" if "variance" in flags else "adaptive"
    torch.manual_seed(1)  # the CLI's --seed: the same initial weights
    grad_method = "undetach" if "undetach" in flags else "detach"
    start = CascadeMVSNet(ndepths=(8, 8, 8), device="cpu", agg_mode=agg_mode,
                          use_geo_fusion="--no_geo_fusion" not in flags,
                          cr_base_chs=(4, 8, 4) if "--cr_base_chs" in flags else (8, 8, 8),
                          use_fmt="--use_fmt" in flags, grad_method=grad_method)
    trainer = cli_train.main(argv)
    model = trainer.state.model
    assert trainer.state.step == 1
    assert (model.fused_train, model.clamp_samples, model.agg_mode) == (fused, fused, agg_mode)
    assert (model.use_fmt, model.grad_method) == ("--use_fmt" in flags, grad_method)
    assert hasattr(model, "GeoFeatureFusionNet") == ("--no_geo_fusion" not in flags)
    start_sd = start.state_dict()
    assert set(model.state_dict()) == set(start_sd)
    moved = [k for k, p in model.named_parameters() if not torch.equal(p.detach(), start_sd[k])]
    assert len(moved) > 0.9 * len(list(model.parameters()))
    if agg_mode == "adaptive":  # the weight nets' BNs normalize with batch statistics
        stats_moved = [k for k, v in model.state_dict().items()
                       if k.startswith("DepthNet") and k.endswith("running_mean")
                       and not torch.equal(v, start_sd[k])]
        assert len(stats_moved) == (0 if fused else 6)
    done = [line for line in capsys.readouterr().out.splitlines()
            if line.startswith("epoch 0 done")]
    loss = float(done[0].split(" loss=")[1].split()[0])
    assert np.isfinite(loss)
