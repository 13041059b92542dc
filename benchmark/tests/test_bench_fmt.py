"""``fmt_serve`` through the harness's own comparison at a tiny size on the
CPU, under the cell's limits (``limits/fmt_serve.json``): a sound run is
correct; the control (the FMT reference in fp8 in the program's place)
and a run whose stage-3 answers are stage 2's (``stage2_answer``) are not.
And the configuration's checkpoint writer (``fmt_weights.py``) imports
nothing of the program, starts FMT as the published modules do, and
writes back exactly the arrays the reference reads."""
from __future__ import annotations

import ast
from pathlib import Path

import numpy as np
import torch

from benchmark import calibrate, cells, check, faults, fmt_weights
from benchmark.reference import fmt
from benchmark.run import run

BENCH = Path(__file__).resolve().parents[1]
SEED = 2 ** 31 + 1901
WORKLOAD = "fmt_serve"


def test_sound_run_is_correct(tiny, cpu):
    result, checked = run(tiny(WORKLOAD), SEED, 0.2, False, cpu, 0.0)
    assert result["correct"], checked
    assert set(checked) == {"depth1", "depth2", "depth3", "conf3"}


def test_control_fails(tiny, cpu):
    cell = tiny(WORKLOAD)
    numbers = calibrate.serve_reading(cell, SEED, 0.0, cpu, None, "fp8")["numbers"]
    ok, checked = check.judge(numbers, cell["limits"])
    assert not ok, checked


def test_stage2_answer_is_not_correct(tiny, cpu):
    with faults.FAULTS["stage2_answer"]():
        result, checked = run(tiny(WORKLOAD), SEED, 0.2, False, cpu, 0.0)
    assert not result["correct"], checked


def test_weights_writer_imports_nothing_of_the_program():
    tree = ast.parse((BENCH / "fmt_weights.py").read_text())
    roots = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    roots |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0}
    assert not roots & {"damvsnet_tpu_torch", "damvsnet_tpu", "jax", "jaxlib", "flax"}


def test_seeded_fmt_starts_as_the_published_modules():
    """Every FMT name of the reference's table, LayerNorms at 1 and 0, the
    rest inside their initialisers' bounds, and the same from the same
    seed."""
    a, b = fmt_weights.seeded_fmt(19, "cpu"), fmt_weights.seeded_fmt(19, "cpu")
    assert set(a) == {name for name, _, _ in fmt.table()}
    for name, t in a.items():
        assert torch.equal(t, b[name]), name
        if ".norm" in name:
            assert torch.equal(t, torch.ones_like(t) if name.endswith("weight")
                               else torch.zeros_like(t)), name
    q = a[f"{fmt.PATHWAY}.FMT.layers.0.attention.query_projection.weight"]
    assert q.shape == (32, 32) and q.abs().max() <= (6.0 / 64) ** 0.5
    assert a[f"{fmt.PATHWAY}.smooth_1.weight"].shape == (16, 16, 3, 3)


def test_flat_checkpoint_writes_back_what_the_reference_read():
    cfg = cells.load(WORKLOAD)["config"]
    rcfg = fmt.settings(cfg, "serve")["model"]
    params, buffers = fmt.load_weights(cfg["weights"], rcfg)
    flat = fmt_weights.flat_checkpoint(cfg["weights"], params, buffers, rcfg)
    with np.load(cfg["weights"]) as npz:
        assert set(flat) == set(npz.files)
        for k in npz.files:
            assert np.array_equal(flat[k], npz[k]), k


def test_train_settings_halve_the_rate_at_60_and_80_percent():
    cfg = cells.load(WORKLOAD)["config"]
    s = fmt_weights.train_settings(cfg)
    assert fmt_weights.STEPS // fmt_weights.STEPS_PER_EPOCH == 4
    assert s["optimizer"]["lrepochs"] == "2,3:2"
    assert s["model"]["ndepths"] == fmt_weights.NDEPTHS and s["model"]["use_fmt"] is True
