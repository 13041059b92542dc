"""The plain reference against the port on the CPU at a tiny size, the
port in fp32 (its kernels' plain versions on CPU tensors): the serving
answers of both configurations and the first training steps. The
reference's names for the checkpoint's weights are the port's. A
configuration's every model key reaches the port, and the reference
refuses what it does not implement. A configuration names its reference
module; the two the benchmark has take the default, unchanged, and a
module added as a file is taken with no other edit."""
from __future__ import annotations

import copy
import json
import shutil
import subprocess
import sys
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


# -- a configuration names its reference ---------------------------------

@pytest.mark.parametrize("workload", ["dtu_serve", "variance_serve", "dtu_train",
                                      "dtu_train_ddp4"])
def test_configurations_take_the_default_reference(workload, load_cell):
    cfg = load_cell(workload)["config"]
    assert "reference" not in cfg and reference.for_config(cfg) is reference


@pytest.mark.parametrize("workload, kind, flops", [
    ("dtu_serve", "serve", 672334611000), ("variance_serve", "serve", 669627318840),
    ("dtu_train", "train", 2654048764896), ("dtu_train_ddp4", "train", 2654048764896)])
def test_counted_flops_at_the_cells_shapes(workload, kind, flops, load_cell):
    """The counts the cells read before a configuration named its reference
    (0.672 TFLOP a request, 2.654 a step of the global batch)."""
    from benchmark import yardstick
    cell = load_cell(workload)
    assert yardstick.counted_flops(cell["config"], cell["traffic"], kind) == flops


def _parent_call(self, imgs, proj_matrices, depth_values):
    """``Cascade.__call__`` as it was before its stage features became the
    ``features`` method, word for word."""
    import torch.nn.functional as F
    from benchmark.reference import ops
    cfg = self.cfg
    b, n, height, width, _ = imgs.shape
    dmin = depth_values.min(1).values.view(-1, 1, 1, 1)
    dmax = depth_values.max(1).values.view(-1, 1, 1, 1)
    nchw = imgs.permute(0, 1, 4, 2, 3)
    if self.training:
        per_view = [self.feature(nchw[:, v]) for v in range(n)]
        feats = {k: [f[k] for f in per_view] for k in per_view[0]}
    else:
        both = self.feature(nchw.reshape(b * n, 3, height, width))
        feats = {k: list(f.reshape(b, n, *f.shape[1:]).unbind(1)) for k, f in both.items()}
    outputs, depth, sigma = {}, None, None
    for i, ndepth in enumerate(cfg["ndepths"]):
        name = f"stage{i + 1}"
        h, w = height >> (2 - i), width >> (2 - i)
        ref, *srcs = feats[name]
        if i == 0:
            samples = ops.uniform_samples(depth_values, ndepth, h, w)
        else:
            if cfg["use_geo_fusion"]:
                rgb = F.interpolate(nchw[:, 0], size=(h, w), mode="bilinear",
                                    align_corners=False)
                d_in = F.interpolate(depth[:, None], size=(2 * depth.shape[1],
                                                           2 * depth.shape[2]),
                                     mode="bilinear", align_corners=False)
                ref = self.geo_fusion(rgb, d_in, depth_values, i, ref)
            depth, sigma = depth.detach(), sigma.detach()
            up = lambda t: F.interpolate(t[:, None], size=(height, width),  # noqa: E731
                                         mode="bilinear", align_corners=False)
            samples = ops.adia_samples(up(depth), up(sigma), ndepth)
            if cfg["clamp_samples"]:
                samples = torch.minimum(torch.maximum(samples, dmin), dmax)
            if (h, w) != (height, width):
                samples = F.interpolate(samples[:, None], size=(ndepth, h, w),
                                        mode="trilinear", align_corners=False)[:, 0]
        projs = ops.fuse_proj(proj_matrices[name].reshape(b * n, 2, 4, 4)).view(b, n, 4, 4)
        volume = self.cost_volume(i, ref, srcs, projs[:, 0],
                                  list(projs[:, 1:].unbind(1)), samples)
        out = ops.prob_stats(self.costreg(volume, i), samples)
        out["depth_values"] = samples
        depth, sigma = out["depth"], out["variance"]
        outputs[name] = out
    outputs.update(outputs["stage3"])
    return outputs


@pytest.mark.parametrize("training", [False, True])
def test_features_method_keeps_the_forward_bitwise(training, cpu):
    from benchmark.reference.model import Cascade
    cfg = _config()
    rcfg = reference.settings(cfg, "train" if training else "serve")["model"]
    params, buffers = reference.load_weights(cells.load("dtu_train")["config"]["weights"], rcfg)
    batch = scenes.make_pool(2 ** 31 + 7, 1, 2, 64, 96, 3, 48, "cpu", True)[0]
    x = {k: torch.as_tensor(np.asarray(batch[k]), dtype=torch.float32) if k != "proj_matrices"
         else {s: torch.as_tensor(v, dtype=torch.float32) for s, v in batch[k].items()}
         for k in ("imgs", "proj_matrices", "depth_values")}
    args = (x["imgs"], x["proj_matrices"], x["depth_values"])
    with torch.no_grad():
        now = Cascade(params, buffers, rcfg, training=training)(*args)
        before = _parent_call(Cascade(params, buffers, rcfg, training=training), *args)
    assert set(now) == set(before)
    for stage in ("stage1", "stage2", "stage3"):
        for k, v in before[stage].items():
            assert torch.equal(now[stage][k], v), (stage, k)


def test_default_reference_refuses_fmt_and_names_itself(tmp_path):
    here = tmp_path / "bench"
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(BENCH / sub, here / sub)
    path = here / "configs" / "damvsnet_dtu.json"
    data = json.loads(path.read_text())
    data["model"]["use_fmt"] = True
    path.write_text(json.dumps(data))
    with pytest.raises(SystemExit, match=r"benchmark\.reference.*use_fmt"):
        cells.load("dtu_serve", here=here)


PROBE = '''"""A reference for a configuration with ``use_fmt: true``: the default
reference's arithmetic through a subclass of its Cascade that replaces
``features`` (a test's stand-in for FMT's)."""
import copy

from benchmark import reference as base
from benchmark.reference.model import Cascade

CALLS = dict.fromkeys(("settings", "serve", "counted_pass", "features"), 0)


class Probe(Cascade):
    def features(self, nchw):
        CALLS["features"] += 1
        return super().features(nchw)


def settings(cfg, kind):
    CALLS["settings"] += 1
    plain = copy.deepcopy(cfg)
    plain["model"]["use_fmt"] = False
    out = base.settings(plain, kind)
    out["model"]["use_fmt"] = True
    return out


load_weights = base.load_weights


def serve(params, buffers, model_cfg, batch, precision="fp32"):
    CALLS["serve"] += 1
    return base.serve(params, buffers, model_cfg, batch, precision, cascade=Probe)


def counted_pass(params, buffers, rcfg, batch, training):
    CALLS["counted_pass"] += 1
    return base.counted_pass(params, buffers, rcfg, batch, training, cascade=Probe)
'''

DRIVE = '''import json, sys
sys.path.insert(0, ".")
import torch
from benchmark import cells, check, reference, scenes, yardstick
cell = cells.load("fmt_probe_serve")
ref = reference.for_config(cell["config"])
pool = scenes.make_pool(3, 1, 1, 64, 96, 3, 48, "cpu", False)
answers = check.reference_serve(cell["config"], pool, [0], torch.device("cpu"))
traffic = dict(cell["traffic"], height=64, width=96, nviews=3)
flops = yardstick.counted_flops(cell["config"], traffic, "serve")
print(json.dumps({"module": ref.__name__, "calls": ref.CALLS, "flops": flops,
                  "depth": list(answers[0]["stage3"]["depth"].shape)}))
'''


def test_reference_module_added_as_a_file(tmp_path):
    """In a copy of the checkout, a configuration that names a reference
    module added there, which takes ``use_fmt: true``, passes ``cells.load``
    and reaches that module's ``settings``, ``serve`` (with its subclass's
    ``features``) and ``counted_pass``: no other file changes."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp_path / "weights").mkdir()
    weights_file = cells.load("dtu_serve")["config"]["weights"]
    (tmp_path / "weights" / "bench_ckpt.npz").symlink_to(weights_file)
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "fmt_probe_serve", "config": "fmt_probe",
                               "traffic": "dtu_eval", "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cfg = json.loads((BENCH / "configs" / "damvsnet_dtu.json").read_text())
    cfg.update(name="fmt_probe", reference="fmt_probe")
    cfg["model"]["use_fmt"] = True
    (tmp_path / "benchmark" / "configs" / "fmt_probe.json").write_text(json.dumps(cfg))
    (tmp_path / "benchmark" / "limits" / "fmt_probe_serve.json").write_text(
        (BENCH / "limits" / "dtu_serve.json").read_text())
    (tmp_path / "benchmark" / "reference" / "fmt_probe.py").write_text(PROBE)
    proc = subprocess.run([sys.executable, "-c", DRIVE], cwd=tmp_path, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["module"] == "benchmark.reference.fmt_probe"
    assert got["calls"]["settings"] >= 3 and got["calls"]["serve"] == 1
    assert got["calls"]["counted_pass"] == 1 and got["calls"]["features"] == 2
    assert got["depth"] == [1, 64, 96] and got["flops"] > 0
