"""The port's FMT cascade against the benchmark's plain FMT reference
(``benchmark/reference/fmt.py``) on the CPU, both in fp32, at 64x96 with
N=3 and ndepths (8, 8, 8) (the U-Nets halve H/4, W/4 and D three times).
Seeded random weights, the LayerNorms' affine parameters and the BatchNorm
statistics moved off their initial values, go through the port's exporter
(``save_bench_weights``) and are read back by both sides.

Tolerances, each with its reason (measured at this size):

  * features, max |port - reference| over the stage's largest magnitude:
    3.8e-6, 3.3e-6 and 2.9e-6 at stages 1-3 with the reference's LayerNorm
    epsilon of 1e-5 against the port's 1e-6; 4.7e-7, 7.6e-7 and 7.3e-7 with
    the reference's set to 1e-6 as well, fp32's rounding alone. The
    epsilon's gap (3.3e-6 at stage 1) is eight times the rounding, and
    FEATURE_TOL = 1e-4 leaves 26x over both.
  * the serving answers, as the benchmark's check reads them (mean depth
    gap a stage over the sweep, mean confidence gap at stage 3): at most
    2.7e-7 (epsilon 1e-5) and 2.4e-7 (both at 1e-6): the epsilon hardly
    reaches the depths. ANSWER_TOL = 1e-5, the default reference's own
    serving tolerance, leaves 37x.
  * FMT's eight layers left out of the port (each returns its input; the
    encoding and the pathway stay) moves stage 1's depth by 2.6e-2 of the
    sweep and stage 3's confidence by 2.1e-4: 2,600x and 21x over
    ANSWER_TOL.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import check, scenes
from benchmark.reference import fmt as reference
from damvsnet_tpu_torch.model import CascadeMVSNet
from damvsnet_tpu_torch.nn import fmt as port_fmt
from damvsnet_tpu_torch.utils.weights import load_bench_weights, save_bench_weights

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CONFIG = REPO / "benchmark" / "configs" / "damvsnet_fmt_dtu.json"
FEATURE_TOL = 1e-4
ANSWER_TOL = 1e-5
SEED = 2 ** 31 + 19


@pytest.fixture(autouse=True)
def no_onednn():
    """Torch's own CPU convolutions (tests/test_torch_train_loop.py)."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _config():
    cfg = json.loads(CONFIG.read_text())
    cfg["model"]["ndepths"] = [8, 8, 8]
    return cfg


@pytest.fixture(scope="module")
def weights_file(tmp_path_factory):
    """A seeded FMT cascade, its norms and statistics moved, exported flat."""
    torch.manual_seed(0)
    model = CascadeMVSNet(ndepths=(8, 8, 8), device="cpu", use_fmt=True)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for k, v in model.named_buffers():
            if k.endswith("running_mean"):
                v.copy_(0.1 * torch.randn(v.shape, generator=g))
            elif k.endswith("running_var"):
                v.copy_(0.75 + 0.5 * torch.rand(v.shape, generator=g))
        for k, v in model.named_parameters():
            if ".norm" in k:
                v.add_(0.1 * torch.randn(v.shape, generator=g))
    path = tmp_path_factory.mktemp("fmt_ref") / "seeded_fmt.npz"
    save_bench_weights(model, path)
    return path


@pytest.fixture(scope="module")
def sides(weights_file):
    """(port model, reference (params, buffers, model settings), batch)."""
    torch.manual_seed(1)
    port = load_bench_weights(CascadeMVSNet(ndepths=(8, 8, 8), device="cpu", use_fmt=True),
                              weights_file)
    rcfg = reference.settings(_config(), "serve")["model"]
    params, buffers = reference.load_weights(weights_file, rcfg)
    batch = scenes.make_pool(SEED, 1, 1, 64, 96, 3, 48, "cpu", False)
    return port, (params, buffers, rcfg), batch


def _inputs(batch):
    b = batch[0]
    return (torch.as_tensor(b["imgs"]), {s: torch.as_tensor(v) for s, v in
                                         b["proj_matrices"].items()},
            torch.as_tensor(b["depth_values"]))


def _port_answer(port, batch):
    with torch.no_grad():
        out = port(*_inputs(batch))
    return {"depth": out["depth"].numpy(),
            "photometric_confidence": out["photometric_confidence"].numpy(),
            **{f"stage{i}": {k: out[f"stage{i}"][k].numpy()
                             for k in ("depth", "photometric_confidence")} for i in (1, 2)}}


def _numbers(port, ref, batch):
    params, buffers, rcfg = ref
    answer = {k: {n: t.numpy() for n, t in v.items()}
              for k, v in reference.serve(params, buffers, rcfg, batch[0]).items()}
    return check.serve_numbers([(0, 0, _port_answer(port, batch))], {0: answer}, batch)


@pytest.mark.parametrize("stage", ["stage1", "stage2", "stage3"])
def test_fmt_and_pathway_features_match(sides, stage):
    port, (params, buffers, rcfg), batch = sides
    imgs = _inputs(batch)[0]
    with torch.no_grad():
        got = port.FMT_with_pathway(port._view_features(imgs), torch.float32)[stage]
        want = reference.FmtCascade(params, buffers, rcfg).features(
            imgs.permute(0, 1, 4, 2, 3))[stage]
    want = torch.stack(want, 1).permute(0, 1, 3, 4, 2)
    assert got.dtype == torch.float32 and got.shape == want.shape
    gap = float((got - want).abs().max() / want.abs().max())
    assert gap < FEATURE_TOL, gap


@pytest.fixture(scope="module")
def numbers(sides):
    return _numbers(*sides)


@pytest.mark.parametrize("number", ["depth1", "depth2", "depth3", "conf3"])
def test_serving_answers_match(numbers, number):
    assert numbers[number] < ANSWER_TOL, numbers


def test_fmt_left_out_exceeds_the_tolerance(sides, monkeypatch):
    """Each of the eight layers returning its input: the comparison tells."""
    monkeypatch.setattr(port_fmt.EncoderLayer, "forward",
                        lambda self, x, source, dtype, plain=False: x)
    numbers = _numbers(*sides)
    assert max(numbers.values()) > 100 * ANSWER_TOL, numbers


def test_settings_take_serving_and_refuse_training():
    cfg = _config()
    out = reference.settings(cfg, "serve")
    assert out["model"]["use_fmt"] is True and out["model"]["clamp_samples"] is True
    with pytest.raises(ValueError, match="serves only"):
        reference.settings(cfg, "train")
    cfg["model"]["use_fmt"] = False
    with pytest.raises(ValueError, match="use_fmt"):
        reference.settings(cfg, "serve")


def test_reference_imports_neither_the_program_nor_jax():
    code = ("import sys; sys.path.insert(0, '.'); import benchmark.reference.fmt; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'damvsnet_tpu_torch', 'damvsnet_tpu', 'jax', 'jaxlib', 'flax'}))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_fp8_control_moves_fmt(sides):
    """The control rounds FMT's Dense layers too: with the convolutions'
    rounding alone the stage-1 features differ from the control's."""
    port, (params, buffers, rcfg), batch = sides
    nchw = _inputs(batch)[0].permute(0, 1, 4, 2, 3)
    with torch.no_grad():
        low = reference.FmtCascade(params, buffers, rcfg, precision="fp8")
        convs_only = reference.FmtCascade(params, buffers, rcfg, precision="fp8")
        convs_only.dense = lambda x, name: torch.nn.functional.linear(
            x, params[f"{name}.weight"], params[f"{name}.bias"])
        a, b = low.features(nchw)["stage1"][0], convs_only.features(nchw)["stage1"][0]
    assert float((a - b).abs().max() / b.abs().max()) > 1e-3
    assert np.isfinite(a.numpy()).all()
