"""The port's spans in a traced window: for each span (``runner.*``,
``cascade.*``, ``loop.*``; ``damvsnet_tpu_torch/train/profiler.py``) the
device time of the activities it launched, their count, the device's idle
time while the host was in it, and its calls, summed over the window.

A device activity (kernel, memcpy, memset) is tied to its launch, the CUDA
runtime or driver call with the same correlation id, and credited to the
span open at that launch: the innermost, the one begun last, on any
thread, so that kernels autograd's device thread launches fall under
``loop.backward``. An idle stretch of the device is credited to the span
open at its midpoint by the same rule. A span's numbers include its child
spans'. What no span holds is counted apart, as are activities whose
launch is not in the trace and activities that start before their launch.

    python3 benchmark/spans.py --workload <cell> --seed <n> [--units <n>]

runs the cell's session as ``run.py`` sets it up, traces ``--units`` units
(the traffic's ``trace_units`` by default), and prints the card, the cost
of a span with and without a running profiler, one line per span (ms,
launches, idle ms and calls a unit) and the result as one JSON line.
"""
from __future__ import annotations

import os
import re
import sys
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.trace import WINDOW_SPAN  # noqa: E402

PREFIXES = ("runner.", "cascade.", "loop.")
# the CUDA runtime's and driver's calls (cudaLaunchKernel, cuLaunchKernel,
# cudaMemcpyAsync, ...): host events whose correlation ids are CUPTI's,
# the ids their device activities carry; the host's operators count ids
# of their own from 1, so a name tells the two apart
LAUNCH = re.compile(r"cu(da)?[A-Z]")


def reduce(prof):
    """{"spans": {span: {"device_s", "launches", "idle_s", "calls"}},
    "span_check": {...}} (``summarize``) of a torch.profiler profile,
    within the benchmark's window span where the trace has it, else the
    whole trace. Device activities are the trace's device events less the
    device-side copies of host spans (annotations) and the profiler's own
    buffer events, as ``trace.reduce`` takes them."""
    from torch.autograd import DeviceType
    spans, launches, device, bounds = [], {}, [], None
    for e in prof.profiler.kineto_results.events():
        name, a, b = e.name(), e.start_ns(), e.end_ns()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation() and not name.startswith("Activity Buffer"):
                device.append((a, b, e.correlation_id()))
        elif e.is_user_annotation():
            if name == WINDOW_SPAN:
                bounds = (a, b)
            elif name.startswith(PREFIXES):
                spans.append((a, b, name, e.start_thread_id()))
        elif LAUNCH.match(name):
            launches[e.correlation_id()] = a
    if bounds is None:
        times = [t for s in spans for t in s[:2]] + [t for d in device for t in d[:2]]
        bounds = (min(times), max(times)) if times else (0, 0)
    return summarize(spans, launches, device, *bounds)


def summarize(spans, launches, device, lo, hi):
    """The reduction of ``reduce`` on plain lists, times in ns: spans
    [(start, end, name, thread)], launches {correlation id: time}, device
    activities [(start, end, correlation id)], the window [lo, hi]; an
    activity counts for the part of it inside the window. "span_check":
    "activities" and "device_s" in the window, "outside_device_s",
    "outside_launches" and "outside_idle_s" (no span holds them), "idle_s"
    (the window less the union of the activities), "unresolved" (no
    launch found), "early" (started before its launch) and "early_max_s"
    (the most by which one did: the host's and the device's clocks, as
    the profiler aligns them, disagree by that much at least)."""
    spans = sorted(s for s in spans if s[1] >= lo and s[0] <= hi)
    parent = _parents(spans)
    out = {}
    for _, _, name, _ in spans:
        out.setdefault(name, {"device_s": 0.0, "launches": 0, "idle_s": 0.0, "calls": 0})
        out[name]["calls"] += 1
    check = {"activities": 0, "device_s": 0.0, "outside_device_s": 0.0,
             "outside_launches": 0, "outside_idle_s": 0.0, "idle_s": 0.0,
             "unresolved": 0, "early": 0, "early_max_s": 0.0}

    def credit(i, key, amount):
        while i is not None:
            out[spans[i][2]][key] += amount
            i = parent[i]

    inside = [(max(a, lo), min(b, hi), c) for a, b, c in device if min(b, hi) > max(a, lo)]
    timed = []  # (time the host launched it, seconds), for activities whose launch is known
    for a, b, c in inside:
        check["activities"] += 1
        check["device_s"] += (b - a) / 1e9
        t = launches.get(c)
        if t is None:
            check["unresolved"] += 1
            check["outside_device_s"] += (b - a) / 1e9
            continue
        if a < t:
            check["early"] += 1
            check["early_max_s"] = max(check["early_max_s"], (t - a) / 1e9)
        timed.append((t, (b - a) / 1e9))
    for (t, s), i in zip(timed, _innermost(spans, [t for t, _ in timed])):
        if i is None:
            check["outside_device_s"] += s
            check["outside_launches"] += 1
        else:
            credit(i, "device_s", s)
            credit(i, "launches", 1)
    gaps = _gaps(sorted((a, b) for a, b, _ in inside), lo, hi)
    for (a, b), i in zip(gaps, _innermost(spans, [(a + b) / 2 for a, b in gaps])):
        check["idle_s"] += (b - a) / 1e9
        if i is None:
            check["outside_idle_s"] += (b - a) / 1e9
        else:
            credit(i, "idle_s", (b - a) / 1e9)
    return {"spans": out, "span_check": check}


def _parents(spans):
    """Each span's index of the span it runs inside on its thread (they
    nest there), or None; ``spans`` sorted by start."""
    parent, stacks = [], defaultdict(list)
    for i, (a, b, _, thread) in enumerate(spans):
        stack = stacks[thread]
        while stack and spans[stack[-1]][1] < b:
            stack.pop()
        parent.append(stack[-1] if stack else None)
        stack.append(i)
    return parent


def _innermost(spans, times):
    """For each time, in the order given, the index of the span open then
    that began last (on any thread), or None; ``spans`` sorted by start."""
    found = [None] * len(times)
    active, j = [], 0
    for k in sorted(range(len(times)), key=times.__getitem__):
        t = times[k]
        while j < len(spans) and spans[j][0] <= t:
            active.append(j)
            j += 1
        active = [i for i in active if spans[i][1] >= t]
        found[k] = active[-1] if active else None
    return found


def _gaps(intervals, lo, hi):
    """The stretches of [lo, hi] that no interval of the sorted list covers."""
    gaps, end = [], lo
    for a, b in intervals:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if hi > end:
        gaps.append((end, hi))
    return gaps


def table(result, units):
    """One line a span, in the order they first opened: device ms,
    launches, idle ms and calls a unit; then what no span holds."""
    lines = [f"{'span':30s} {'ms':>9s} {'launches':>9s} {'idle ms':>9s} {'calls':>6s}"]
    for name, v in result["spans"].items():
        lines.append(f"{name:30s} {1e3 * v['device_s'] / units:9.3f} "
                     f"{v['launches'] / units:9.1f} {1e3 * v['idle_s'] / units:9.3f} "
                     f"{v['calls'] / units:6.2f}")
    c = result["span_check"]
    lines.append(f"{'(no span)':30s} {1e3 * c['outside_device_s'] / units:9.3f} "
                 f"{c['outside_launches'] / units:9.1f} {1e3 * c['outside_idle_s'] / units:9.3f}")
    lines.append(f"activities {c['activities']}, unresolved {c['unresolved']}, "
                 f"early {c['early']} (by {1e6 * c['early_max_s']:.3f} us at most), "
                 f"device ms a unit {1e3 * c['device_s'] / units:.3f}, "
                 f"in no span {c['outside_device_s'] / max(c['device_s'], 1e-12):.2%}")
    return "\n".join(lines)


def span_cost_us(n=20000):
    """Host µs to enter and leave one of the port's spans, with no
    profiler running and under one (CPU activity only)."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from damvsnet_tpu_torch.train.profiler import span

    def per_span():
        t0 = time.perf_counter()
        for _ in range(n):
            with span("loop.cost"):
                pass
        return 1e6 * (time.perf_counter() - t0) / n

    off = per_span()
    with profile(activities=[ProfilerActivity.CPU]):
        on = per_span()
    return {"off": off, "on": on}


def main(argv=None):
    import argparse
    import json

    import torch

    from benchmark import cells, program, run, trace

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--units", type=int, default=None)
    args = p.parse_args(argv)
    cell = cells.load(args.workload)
    if not torch.cuda.is_available():
        print(f"{args.workload} needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    units = args.units or cell["traffic"]["trace_units"]
    session = program.SESSIONS[cell["traffic"]["kind"]](cell, args.seed, device)
    try:
        prof = trace.profile(session.unit, units)  # rank 0's spans, across cards
    finally:
        session.close()
    t = trace.reduce(prof, units)
    result = reduce(prof)
    cost = span_cost_us()
    print(f"card: {run.card()}; torch {torch.__version__}")
    print(f"span cost: {cost['off']:.3f} us with no profiler, {cost['on']:.3f} us under one")
    print(table(result, units))
    # a span's device-side copy is an annotation, no device work: none may
    # reach the kernels that trace.reduce counts
    leaked = [k for k in t["kernels"] if k.startswith(PREFIXES)]
    print(json.dumps({"workload": args.workload, "seed": args.seed, "units": units,
                      "busy_s": t["busy_s"], "window_s": t["window_s"], "gaps": t["gaps"],
                      "kernels_device_s": sum(v[0] for v in t["kernels"].values()),
                      "spans_in_kernels": leaked, "span_cost_us": cost, **result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
