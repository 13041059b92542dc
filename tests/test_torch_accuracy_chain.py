"""The port's accuracy chain (scripts/e2e_synthetic_torch.py) on the CPU.

(a) ``SyntheticDataset(mode="train")``, the chain's training data, equals
    the JAX package's sample for sample.
(b) The chain's ``main`` at a tiny size writes a JSON with every key of the
    JAX chain's and the port's own, both fusion backends run, finite scores,
    and a bitwise weights-only restore of the trained weights and running
    statistics; and, with PIL and cv2 hidden, runs under the numpy codec
    without dypcd and says so. 64x64 with ndepths 8/8/8: the cascade's U-Nets halve H/4,
    W/4 and D three times and add the skips back, so W=80 (stage 1 20 wide)
    and D=4 do not build, in either package. Three epochs of 12 steps leave
    fused points within the DTU protocol's 20 mm of the ground truth.
(c) Four consecutive training steps with the chain's optimizer and schedule
    (Adam, 100 warmup steps, x0.5 at milestones reached within the four
    steps) against the JAX package's ``Trainer`` step from the same weights
    (the chain's seeded model, carried through utils/weights.py's table)
    on the same batches, in fp32 with align_corners; both sides compute
    BN's batch variance two-pass (tests/test_torch_train_step.py). The lr
    of every step equals JAX's schedule; the first step's loss agrees to
    1e-4. The later losses are held to the larger of 1e-3 and twice the
    largest move of JAX's own losses when every weight moves by one fp32
    ulp: Adam's first update is lr * sign(gradient), so entries whose
    gradient lies at the rounding floor move by +-lr at random in either
    package, and JAX's own trajectory drifts by percents by step 3.
"""
import builtins
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from damvsnet_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from damvsnet_tpu_torch.core import imageio
from damvsnet_tpu_torch.data.common import DataLoader
from damvsnet_tpu_torch.data.synthetic import SyntheticDataset
from damvsnet_tpu_torch.utils.weights import _table as weight_table
from torch_helpers import flax_two_pass_variance, port_flax_flat, unflat

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--height", "64", "--width", "64", "--nviews", "3", "--d0", "16",
        "--ndepths", "8,8,8", "--epochs", "3", "--epoch_len", "24", "--align_corners"]
# the JAX chain's report keys (ACCURACY_r04.json), then the port's own
JAX_KEYS = {"config", "workdir", "device", "n_params", "train_curve", "train_steps",
            "inference", "depth", "fusion", "dtu_protocol", "elapsed_sec"}
PORT_KEYS = {"dtu_protocol_device_backend", "train_step_ms_median", "peak_gib",
             "checkpoint", "reduced"}
SCORES = ("acc", "comp", "overall", "acc_med", "comp_med")
# (c): each step's loss within the larger of 1e-3 and ULP_FACTOR times the
# largest move of JAX's own losses over ULP_TRIALS one-ulp weight changes
ULP_TRIALS, ULP_FACTOR = 3, 2.0


def chain():
    """scripts/e2e_synthetic_torch.py as a module."""
    spec = importlib.util.spec_from_file_location(
        "e2e_synthetic_torch", os.path.join(REPO, "scripts", "e2e_synthetic_torch.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("idx", [0, 5, 10_000])
def test_training_samples_match_jax(idx):
    kw = dict(mode="train", nviews=3, ndepths=16, height=64, width=64, length=16)
    got, want = SyntheticDataset(**kw)[idx], JSyntheticDataset(**kw)[idx]
    assert set(got) == set(want)
    for key, w in want.items():
        if isinstance(w, dict):
            assert set(got[key]) == set(w), key
            for stage in w:
                np.testing.assert_array_equal(got[key][stage], w[stage], err_msg=key)
        elif isinstance(w, str):
            assert got[key] == w
        else:
            np.testing.assert_array_equal(got[key], w, err_msg=key)


@pytest.mark.parametrize("codecs", ["installed", "missing"])
def test_chain_runs_end_to_end(tmp_path, monkeypatch, codecs):
    """With PIL and cv2 missing (imports of them raise), the images go
    through the numpy stand-in, dypcd is not run and the device filter's
    cloud is scored, all said in the JSON."""
    if codecs == "missing":
        real_import = builtins.__import__

        def no_codecs(name, *args, **kwargs):
            if name.split(".")[0] in ("PIL", "cv2"):
                raise ImportError(f"{name} hidden by the test")
            return real_import(name, *args, **kwargs)

        monkeypatch.setattr(imageio, "codecs_missing", lambda: ["PIL", "cv2"])
        monkeypatch.setattr(builtins, "__import__", no_codecs)
    out = tmp_path / "accuracy.json"
    report = chain().main(TINY + ["--workdir", str(tmp_path / "work"), "--out", str(out)])
    with open(out) as f:
        written = json.load(f)
    assert set(written) == JAX_KEYS | PORT_KEYS
    assert written["device"] == "cpu"
    assert len(written["reduced"]) == (0 if codecs == "installed" else 2)
    assert written["train_steps"] == 3 * 24 // 2 and len(written["train_curve"]) == 3
    assert all(np.isfinite(e["loss"]) for e in written["train_curve"])
    assert written["checkpoint"] == {"tensors": 550, "restored_bitwise": True}
    assert written["inference"]["views"] == 3
    assert not any(written["inference"]["launches"].values())  # CPU tensors: no kernel
    assert written["depth"]["finite"] and 0 < written["depth"]["frac_within_1_interval"] <= 1
    if codecs == "installed":
        assert written["fusion"]["dypcd"] == "run"
        assert written["dtu_protocol"]["backend"] == "dypcd"
    else:
        assert written["fusion"]["dypcd"] == "not run: no PIL or cv2"
        assert written["dtu_protocol"] == dict(written["dtu_protocol_device_backend"],
                                               backend="device")
    for key in ("dtu_protocol", "dtu_protocol_device_backend"):
        assert all(np.isfinite(written[key][s]) for s in SCORES), written[key]
    assert report["fusion"] == written["fusion"]
    # the restore is not vacuous: training moved the running statistics
    ckpt = torch.load(tmp_path / "work" / "ckpt" / "ckpt_000003.pt", weights_only=True)
    assert float(ckpt["model"]["feature.conv0.0.bn.running_mean"].abs().max()) > 0


def _ulp_moved(flat, seed):
    """Every parameter moved by one fp32 ulp, up or down (seeded); the BN
    statistics as they are."""
    rs = np.random.default_rng(seed)
    inf = np.float32(np.inf)
    return {k: (np.nextafter(v, np.where(rs.random(v.shape) < 0.5, inf, -inf)).astype(np.float32)
                if k.startswith("params/") else v) for k, v in flat.items()}


def test_four_steps_match_jax_trainer(tmp_path):
    from damvsnet_tpu.model import CascadeMVSNet as JCascade
    from damvsnet_tpu.train.loop import Trainer as JTrainer
    from damvsnet_tpu.train.schedule import make_optimizer as jmake_optimizer
    from damvsnet_tpu.train.state import TrainState as JTrainState
    from damvsnet_tpu_torch.train.loop import Trainer

    e2e = chain()
    # 2 epochs of 2 steps: milestones at steps 2 and 4 ("1,2:2"), inside
    # the 100-step warmup
    args = e2e.parse_args(TINY + ["--epochs", "2", "--epoch_len", "4"])
    loader = DataLoader(SyntheticDataset(mode="train", nviews=3, ndepths=16, height=64,
                                         width=64, length=4), 2, shuffle=True, seed=1,
                        num_workers=0)
    batches = [b for epoch in range(2) for b in loader.iter_epoch(epoch)]
    dev = torch.device("cpu")
    model = e2e.build_model(args, dev, seed=1)
    flat = port_flax_flat(model, weight_table())
    state = e2e.make_state(model, args, len(loader))
    trainer = Trainer(state, str(tmp_path / "port"), use_cpc=True, device=dev)
    got, lrs = [], []
    with torch.backends.mkldnn.flags(enabled=False):
        for b in batches:
            lrs.append(state.optimizer.param_groups[0]["lr"])
            got.append(float(trainer.train_step(state, b)["loss"]))

    jmodel = JCascade(ndepths=(8, 8, 8), agg_mode="adaptive", use_geo_fusion=True,
                      sampler_opts={"align_corners": True})
    tx, sched = jmake_optimizer(args.lr, "1,2:2", len(loader), 0.0, warmup_iters=100)
    jtrainer = JTrainer(jmodel, None, str(tmp_path / "jax"), use_cpc=True)

    def jax_losses(flat):
        variables = unflat(flat)
        jstate = JTrainState(step=0, epoch=0, params=variables["params"],
                             batch_stats=variables["batch_stats"],
                             opt_state=tx.init(variables["params"]), tx=tx)
        losses = []
        with flax_two_pass_variance():
            for b in batches:
                jb = {k: v for k, v in b.items() if k != "filename"}
                jstate, metrics = jtrainer.train_step(
                    jstate, jax.tree_util.tree_map(jnp.asarray, jb))
                losses.append(float(metrics["loss"]))
        return np.array(losses)

    want = jax_losses(flat)
    n_params = sum(int(np.prod(v.shape)) for k, v in flat.items() if k.startswith("params/"))
    assert n_params == sum(p.numel() for p in model.parameters())
    np.testing.assert_allclose(lrs, [float(sched(k)) for k in range(4)], rtol=1e-6)
    moved = np.abs(np.array(got) / want - 1)
    # JAX's own trajectory under one-ulp weight changes: Adam's first update
    # is lr * sign(gradient), so entries whose gradient lies at the rounding
    # floor move by +-lr at random, and the loss drifts by percents by step 3
    floor = np.max([np.abs(jax_losses(_ulp_moved(flat, seed)) / want - 1)
                    for seed in range(ULP_TRIALS)], axis=0)
    assert moved[0] <= 1e-4, moved
    limit = np.maximum(1e-3, ULP_FACTOR * floor)
    assert (moved <= limit).all(), {"moved": moved, "jax_one_ulp_floor": floor}


def test_use_fmt_builds_trains_and_exports_the_fmt_model(tmp_path):
    """``--use_fmt`` builds CascadeMVSNet(use_fmt=True); ``--init`` with
    bench_ckpt.npz (no FMT keys) keeps FMT's seeded start and loads the rest;
    ``--export`` writes the trained weights in the flat layout, which load
    strictly into an FMT model, and training left no tensor at its start."""
    from damvsnet_tpu_torch.utils.weights import load_bench_weights
    module = chain()
    args = module.parse_args(["--use_fmt", "--device", "cpu"])
    assert module.build_model(args, torch.device("cpu"), seed=1).use_fmt
    assert not module.build_model(module.parse_args(["--device", "cpu"]), torch.device("cpu"),
                                  seed=1).use_fmt
    out, export = tmp_path / "accuracy.json", tmp_path / "fmt.npz"
    tiny = [a for a in TINY if a != "--align_corners"]
    tiny[tiny.index("--epochs") + 1], tiny[tiny.index("--epoch_len") + 1] = "1", "4"
    with pytest.warns(UserWarning, match="FMT_with_pathway keep their seeded initialisation"):
        report = module.main(tiny + ["--use_fmt", "--init", os.path.join(REPO, "weights",
                                                                         "bench_ckpt.npz"),
                                     "--export", str(export), "--workdir", str(tmp_path / "w"),
                                     "--out", str(out)])
    assert report["init"]["seeded"] == ["FMT_with_pathway"]
    assert report["export"]["arrays"] == 460 + 8 * 16 + 4
    assert report["export"]["left_at_start"] == []
    assert report["checkpoint"]["restored_bitwise"]
    from damvsnet_tpu_torch.model import CascadeMVSNet
    load_bench_weights(CascadeMVSNet(ndepths=(8, 8, 8), device="cpu", use_fmt=True), export)
