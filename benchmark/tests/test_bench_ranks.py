"""The session of one process a card (``ranks.py``) on the CPU: two gloo
ranks of ``dtu_train_ddp4`` at the tiny size, one row a rank. A sound run
is correct against the one-process reference on the global batch, with
the ranks' parameters equal; a rank that keeps its own gradient leaves
the replicas apart; a rank that raises ends the run, non-zero, within its
limit, with that rank's tail. The window lengthens the ranks' limit by its
seconds, and reading the peak leaves the ranks running."""
from __future__ import annotations

import subprocess
import sys
import textwrap
import time
from pathlib import Path

from benchmark import faults, program
from benchmark.run import run

TESTS = Path(__file__).resolve().parent
SEED = 2 ** 32 + 17
LIMIT_S = 150


def test_two_ranks_run_and_match_the_reference(tiny, cpu):
    cell = tiny("dtu_train_ddp4")
    assert cell["chips"] == 2 and cell["traffic"]["batch"] == 2
    result, checked = run(cell, SEED, 0.5, False, cpu, 0.0)
    assert result["correct"], checked
    assert checked["replicas"]["value"] == 0.0, checked
    assert result["attempted"] >= 1 and result["failed"] == 0
    rate = result["metrics"]["train_samples_per_s"]
    assert rate["unit"] == "samples/s" and rate["value"] > 0


def test_rank_keeping_its_own_gradient_parts_the_replicas(tiny, cpu):
    with faults.FAULTS["skip_allreduce"]():
        result, checked = run(tiny("dtu_train_ddp4"), SEED, 0.2, False, cpu, 0.0)
    assert checked["replicas"]["value"] > 0 and not result["correct"], checked


def test_rank_that_raises_ends_the_run(tmp_path):
    script = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{str(TESTS.parents[1])!r}, {str(TESTS)!r}]
        import torch
        from conftest import tiny_cell
        from benchmark import faults
        from benchmark.run import run
        with torch.backends.mkldnn.flags(enabled=False), faults.FAULTS["rank_raises"]():
            run(tiny_cell("dtu_train_ddp4"), {SEED}, 0.2, False, torch.device("cpu"), 0.0)
        print("the run went on")
        """)
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=LIMIT_S + 60, cwd=tmp_path)
    assert time.monotonic() - t0 < LIMIT_S
    assert proc.returncode != 0 and "the run went on" not in proc.stdout
    assert "--- rank 1, exit" in proc.stderr, proc.stderr[-3000:]
    assert "rank_raises: this rank's step fails" in proc.stderr, proc.stderr[-3000:]


class _Ranks:
    """Stands in for ``ranks.Ranks``: records the lines rank 0 writes."""
    ready, deadline = False, 0.0

    def __init__(self):
        self.lines = []

    def extend(self, seconds):
        self.deadline += seconds

    def command(self, line):
        self.lines.append(line)

    def replies(self, kind):
        return [{"reply": kind, "memory_peak_bytes": 5}]


def test_window_extends_the_limit_and_the_peak_leaves_the_ranks_running(cpu):
    session = object.__new__(program.TrainRanks)
    session.ranks, session.device = _Ranks(), cpu
    session.unit = lambda: (0.001, {"loss": 0.5}, None)
    win = session.window(0.05)
    assert win["units"] >= 1 and session.ranks.deadline == 0.05
    assert session.memory_peak_bytes() == 5 and session.ranks.lines == ["memory"]
