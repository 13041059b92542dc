"""What the metric readers (``metrics/<metric>.py``) share: each takes the
run's record and returns a number, or None where the record holds nothing
for it (another kind of cell, or a run without its trace).

The record: "kind" ("serve" or "train": the configuration's group the
session runs), "chips" (the cell's cards), "setup_s", "units" (requests
or steps in the window), "samples_per_unit" (over every card),
"window_s", "dispatch_s" (the host's time in the program's calls over the
window, on the first card's process), "latencies_s" (serving),
"flops_per_unit" and "bounds_ms" (kernel: least ms a unit), and, in a
traced run, "trace" (``trace.reduce`` of the first card's process; across
cards its "busy_s" and "window_s" are the cards' means).
"""
from __future__ import annotations


def traced(record, kind):
    """The trace of a run of this kind, or None."""
    return record.get("trace") if record["kind"] == kind else None


def family_ms(record, kind, *families):
    """Device ms a unit in the named families."""
    t = traced(record, kind)
    if t is None:
        return None
    return 1e3 * sum(t["families"].get(f, 0.0) for f in families) / t["units"]


def kernel_ms(record, name_part):
    """Device ms a unit of the kernels whose name holds ``name_part``;
    None where no such kernel ran."""
    t = record.get("trace")
    if t is None:
        return None
    s = sum(v[0] for k, v in t["kernels"].items() if name_part in k)
    return 1e3 * s / t["units"] if s > 0 else None


def roofline(record, bound, name_part):
    """The kernel's least time over its measured time, in %."""
    ms = kernel_ms(record, name_part)
    least = record.get("bounds_ms", {}).get(bound)
    return None if ms is None or least is None else 100.0 * least / ms


def idle_share(record, kind):
    t = traced(record, kind)
    return None if t is None else 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mfu(record, kind, peak_flops):
    """Counted FLOPs a unit x units a second over the window, as a share
    of the peak of the cell's cards together, in %."""
    if record["kind"] != kind or record.get("flops_per_unit") is None:
        return None
    rate = record["flops_per_unit"] * record["units"] / record["window_s"]
    return 100.0 * rate / (peak_flops * record["chips"])


def dispatch_ms(record, kind):
    if record["kind"] != kind:
        return None
    return 1e3 * record["dispatch_s"] / record["units"]
