"""Shared fixtures of the benchmark's CPU tests: cells of the benchmark cut
to a size the CPU runs in seconds (128x160, 3 views), and the card's
check for the tests marked ``cuda``."""
from __future__ import annotations

import copy
import json
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from benchmark import cells, program  # noqa: E402

TINY = {"height": 128, "width": 160, "nviews": 3, "check_sample": 2}
RANKS_CELL = "dtu_train_ddp4"
RANKS_PER_LAYER = ("loop.dispatch_ms.train", "loop.loss_idle_ms.train", "nn.conv_ms.train",
                   "ops.elementwise_ms.train", "device.idle_share.train", "device.mfu.train")


def with_ranks_cell(bench=None):
    """BENCHMARK.json with ``dtu_train_ddp4``, the training cell on four
    cards whose files the harness holds but whose entry waits for a bound
    (PERF.md), added as its entry would be: the workload, the cell in the
    lists of ``train_samples_per_s`` and of the training per-layer metrics
    its rank 0 reports, and ``dist.nccl_ms.train``."""
    bench = copy.deepcopy(bench or json.loads((cells.ROOT / "BENCHMARK.json").read_text()))
    bench["workloads"].append({"name": RANKS_CELL, "config": "damvsnet_dtu",
                               "traffic": RANKS_CELL, "chips": 4, "why": "DDP on four cards"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("train_samples_per_s",) + RANKS_PER_LAYER:
            m["workloads"].append(RANKS_CELL)
    bench["per_layer"].append({"name": "dist.nccl_ms.train", "unit": "ms", "better": "lower",
                               "source": "device_trace", "layer": "NCCL collectives",
                               "moves": "train_samples_per_s", "workloads": [RANKS_CELL]})
    return bench


def load(workload):
    """``cells.load`` of the workload, ``dtu_train_ddp4`` among them."""
    return cells.load(workload, bench=with_ranks_cell())


def tiny_cell(workload, dtype="float32", **traffic):
    """The cell as ``load`` has it, at 128x160 with 3 views and the
    traffic's other fields; fp32 unless ``dtype`` says otherwise (the CPU's
    oneDNN convolutions are off, see ``cpu``). A cell on more than one card
    takes two ranks, over gloo on the CPU: one row a rank, as on the cards."""
    cell = load(workload)
    train = program.SESSIONS[cell["traffic"]["kind"]].GROUP == "train"
    cell["traffic"].update(TINY, pool=3 if train else 2, batch=2 if train else 1, **traffic)
    cell["config"]["compute_dtype"] = dtype
    cell["chips"] = min(cell["chips"], 2)
    return cell


@pytest.fixture
def load_cell():
    """``load``."""
    return load


@pytest.fixture
def tiny():
    """``tiny_cell``."""
    return tiny_cell


@pytest.fixture
def cpu():
    """The CPU, oneDNN off: its convolution backward corrupts the heap at
    the cascade's small training shapes (the repository's training tests
    run the same way)."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield torch.device("cpu")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
