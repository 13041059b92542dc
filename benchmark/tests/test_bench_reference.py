"""The plain reference against the port on the CPU at a tiny size, the
port in fp32 (its kernels' plain versions on CPU tensors): the serving
answers of both configurations and the first training steps. The
reference's names for the checkpoint's weights are the port's. A
configuration's every model key reaches the port, and the reference
refuses what it does not implement."""
from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import cells, check, program, reference, scenes
from benchmark.reference import weights

BENCH = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("workload", ["dtu_serve", "variance_serve"])
def test_serving_matches_the_port(workload, tiny, cpu):
    cell = tiny(workload)
    model = program.build_model(cell["config"], "serve", cpu)
    cfg = cell["config"]
    params, buffers = weights.load(cfg["weights"], cfg["model"]["agg_mode"] == "adaptive",
                                   True)
    names = {k for k in model.state_dict() if not k.endswith("num_batches_tracked")}
    assert names == set(params) | set(buffers)
    for k, v in model.state_dict().items():
        if k in params or k in buffers:
            assert torch.equal(v, (params | buffers)[k]), k
    session = program.Serve(cell, 2 ** 40 + 3, cpu, model=model)
    win = session.window(0.1)
    answers = check.reference_serve(cfg, session.pool, [s for _, s, _ in win["kept"]], cpu)
    numbers = check.serve_numbers(win["kept"], answers, session.pool)
    assert max(numbers.values()) < 1e-5, numbers


def test_training_steps_match_the_port(tiny, cpu):
    cell = tiny("dtu_train")
    session = program.Train(cell, 2 ** 33 + 1, cpu)
    ref = check.reference_train(cell["config"], session.pool[:3],
                                cell["traffic"]["iters_per_epoch"], cpu)
    numbers = check.train_readings(session.first, ref, session.pool[0])
    # fp32 on both sides: the losses and depths to rounding; Adam's
    # sign-like first updates leave a leaf's change within a few percent
    assert numbers["loss"] < 1e-3 and numbers["depth"] < 1e-5, numbers
    assert numbers["grad_worst"] < 1e-2 and numbers["stats_worst"] < 1e-2, numbers
    assert numbers["change_worst"] < 5e-2, numbers


def test_scenes_repeat_from_the_seed():
    a = scenes.make_pool(2 ** 31 + 11, 2, 1, 64, 96, 3, 48, "cpu", True)
    b = scenes.make_pool(2 ** 31 + 11, 2, 1, 64, 96, 3, 48, "cpu", True)
    c = scenes.make_pool(2 ** 31 + 12, 2, 1, 64, 96, 3, 48, "cpu", True)
    assert all(np.array_equal(x["imgs"], y["imgs"]) for x, y in zip(a, b))
    assert not np.array_equal(a[0]["imgs"], c[0]["imgs"])
    assert a[0]["imgs"].shape == c[0]["imgs"].shape == (1, 3, 64, 96, 3)


def test_scene_renderer_is_the_ports():
    """The device renderer draws the numpy renderer's scene from the same
    generator state."""
    from damvsnet_tpu_torch.data import synthetic
    rng = np.random.default_rng(5)
    imgs, depths, _, exts = scenes.render_views(64, 96, 3, rng, "cpu")
    want = synthetic.render_synthetic_views(64, 96, 3, seed=5)
    np.testing.assert_allclose(imgs, want["imgs"], atol=1e-5)
    np.testing.assert_allclose(depths, want["depths"], rtol=1e-6)
    np.testing.assert_array_equal(exts, want["exts"])


def _config(workload="dtu_train"):
    return copy.deepcopy(cells.load(workload)["config"])


@pytest.mark.parametrize("kind, group, key, value", [
    ("serve", "model", "use_fmt", True),
    ("serve", "model", "reg_mode", "georeg"),
    ("serve", "model", "refine", True),
    ("serve", "model", "align_corners", True),
    ("serve", "model", "cr_base_chs", [16, 8, 8]),
    ("train", "model", "fused_train", True),
    ("train", "model", "grad_method", "undetach"),
    ("train", "optimizer", "weight_decay", 0.01),
    ("serve", "model", "fmt_sp_group", None),  # a key the reference does not know
    ("train", "loss", "use_cpc", False),
    ("train", "loss", "grad_accum", 2),
])
def test_reference_refuses_what_it_does_not_implement(kind, group, key, value):
    cfg = _config()
    reference.settings(cfg, kind)
    target = cfg[kind][group] if key in cfg[kind][group] or group != "model" else cfg["model"]
    target[key] = value
    with pytest.raises(ValueError):
        reference.settings(cfg, kind)


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_reference_refuses_a_missing_key(kind):
    cfg = _config()
    del cfg["model"]["refine"]
    with pytest.raises(ValueError, match="missing"):
        reference.settings(cfg, kind)


@pytest.mark.parametrize("workload", ["dtu_serve", "dtu_train"])
def test_program_gets_every_model_key(workload, monkeypatch, cpu):
    """The port's model is built from the configuration's whole model
    group and its kind's: what the reference checks is what runs."""
    import damvsnet_tpu_torch.model as model_module
    seen = {}

    def record(**kwargs):
        seen.update(kwargs)
        raise RuntimeError("recorded")

    monkeypatch.setattr(model_module, "CascadeMVSNet", record)
    cell = cells.load(workload)
    kind = cell["traffic"]["kind"]
    with pytest.raises(RuntimeError, match="recorded"):
        program.build_model(cell["config"], kind, cpu)
    want = reference.settings(cell["config"], kind)["model"]
    assert set(seen) == set(want) | {"compute_dtype", "device"}
    assert all(seen[k] == (tuple(v) if isinstance(v, list) else v) for k, v in want.items())


@pytest.mark.parametrize("part", ["config", "traffic"])
def test_cells_refuse_keys_nothing_reads(part, tmp_path):
    here = tmp_path / "bench"
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(BENCH / sub, here / sub)
    path = here / ("configs/damvsnet_dtu.json" if part == "config" else "traffic/dtu_eval.json")
    data = json.loads(path.read_text())
    data["stats_dtype" if part == "config" else "rate_per_s"] = "float32"
    path.write_text(json.dumps(data))
    with pytest.raises(SystemExit):
        cells.load("dtu_serve", here=here)
