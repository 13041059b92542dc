"""Shared fixtures of the benchmark's CPU tests: cells of the benchmark cut
to a size the CPU runs in seconds (128x160, 3 views), and the card's
check for the tests marked ``cuda``."""
from __future__ import annotations

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from benchmark import cells  # noqa: E402

TINY = {"height": 128, "width": 160, "nviews": 3, "check_sample": 2}


def tiny_cell(workload, dtype="float32", **traffic):
    """The cell as BENCHMARK.json has it, at 128x160 with 3 views and the
    traffic's other fields; fp32 unless ``dtype`` says otherwise (the CPU's
    oneDNN convolutions are off, see ``cpu``)."""
    cell = cells.load(workload)
    train = cell["traffic"]["kind"] == "train"
    cell["traffic"].update(TINY, pool=3 if train else 2, batch=2 if train else 1, **traffic)
    cell["config"]["compute_dtype"] = dtype
    return cell


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
