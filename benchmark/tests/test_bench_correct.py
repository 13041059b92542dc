"""``correct`` at a tiny size on the CPU, under the cells' own limits:
a sound run passes; the control, the reference in fp8 in the program's
place, fails; and a run with the timed path broken underneath (each
fault of ``faults.py`` the cell can have) comes out not correct.

The harness's look for a card is skipped (``run.run`` on the CPU; a cell
on more than one card takes two gloo ranks there); the last test, marked
``cuda``, runs each cell on the card for a short window."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import calibrate, check, faults, program
from benchmark.run import run

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 101


@pytest.mark.parametrize("workload", ["dtu_serve", "variance_serve", "dtu_train"])
def test_sound_run_is_correct(workload, tiny, cpu):
    result, checked = run(tiny(workload), SEED, 0.2, False, cpu, 0.0)
    assert result["correct"], checked


@pytest.mark.parametrize("workload", ["dtu_serve", "variance_serve", "dtu_train",
                                      "dtu_train_ddp4"])
def test_control_fails(workload, tiny, cpu):
    cell = tiny(workload)
    if program.SESSIONS[cell["traffic"]["kind"]].GROUP == "serve":
        numbers = calibrate.serve_reading(cell, SEED, 0.0, cpu, None, "fp8")["numbers"]
    else:
        numbers = calibrate.train_reading(cell, SEED, cpu, "fp8")["numbers"]
    ok, checked = check.judge(numbers, cell["limits"])
    assert not ok, checked


def test_judge_compares_the_numbers_with_limits():
    numbers = {"loss": 0.5, "grad": 0.001, "replicas": 0.0}
    ok, checked = check.judge(numbers, {"loss": None, "grad": 0.01, "replicas": 0.0})
    assert ok and set(checked) == {"grad", "replicas"}
    assert not check.judge(numbers, {"loss": None, "grad": 0.0001, "replicas": 0.0})[0]
    with pytest.raises(KeyError):
        check.judge(numbers, {"grad": 0.01, "replicas": 0.0})


@pytest.mark.parametrize("workload, fault", [
    ("dtu_serve", "stage2_answer"), ("variance_serve", "stage2_answer"),
    ("dtu_train", "half_batch"), ("dtu_train", "frozen_state"),
    ("dtu_train_ddp4", "half_batch"), ("dtu_train_ddp4", "frozen_state")])
def test_broken_timed_path_is_not_correct(workload, fault, tiny, cpu):
    with faults.FAULTS[fault]():
        result, checked = run(tiny(workload), SEED, 0.2, False, cpu, 0.0)
    assert not result["correct"], checked


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["dtu_serve", "variance_serve", "dtu_train"])
def test_cell_on_the_card(workload, card):
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload,
                           "--seed", str(SEED), "--seconds", "3", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu", line
