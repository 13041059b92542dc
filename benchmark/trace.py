"""The traced window: torch.profiler over a few units of the cell's own
work, reduced to device time by kernel and family, the device's busy time
(the union of its activities' intervals, so activities that overlap on
streams count once), and the idle gaps named by what the host was doing.
"""
from __future__ import annotations

from collections import defaultdict

import torch

from .yardstick import family, union_length

WINDOW_SPAN = "bench.window"


def profile(run_unit, units):
    """Run ``units`` units under the profiler, inside a span that ends
    after the device has finished. Returns the profiler."""
    from torch.profiler import ProfilerActivity, profile as _profile, record_function
    with _profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_SPAN):
            for _ in range(units):
                run_unit()
            torch.cuda.synchronize()
    return prof


def reduce(prof, units):
    """{"units", "window_s", "busy_s", "kernels": {name: [s, count]},
    "families": {family: s}, "gaps": {host activity: s}}, times summed
    over the traced window."""
    from torch.autograd import DeviceType
    events = prof.events()
    window = next(e for e in events if e.name == WINDOW_SPAN)
    lo, hi = window.time_range.start, window.time_range.end
    device, host = [], []
    for e in events:
        a, b = max(e.time_range.start, lo), min(e.time_range.end, hi)
        if e.device_type == DeviceType.CUDA:
            # the profiler mirrors each host span onto the device's timeline
            # as a user annotation: it is no device work
            annotation = getattr(e, "is_user_annotation", False) or e.name.startswith("bench.")
            if b > a and not annotation and not e.name.startswith("Activity Buffer"):
                device.append((e.name, a, b))
        elif e.name != WINDOW_SPAN and b > a:
            parent = e.cpu_parent
            if parent is None or parent.name.startswith("bench."):
                label = e.name if parent is None else f"{parent.name}/{e.name}"
                host.append((a, b, label))
    return summarize(device, host, lo, hi, units)


def summarize(device, host, lo, hi, units):
    """The reduction of ``reduce`` on plain lists: device [(name, start,
    end)] and host [(start, end, label)] in microseconds, the window
    [lo, hi]."""
    kernels = defaultdict(lambda: [0.0, 0])
    families = defaultdict(float)
    for name, a, b in device:
        kernels[name][0] += (b - a) / 1e6
        kernels[name][1] += 1
        families[family(name)] += (b - a) / 1e6
    busy = union_length([(a, b) for _, a, b in device])
    return {"units": units, "window_s": (hi - lo) / 1e6, "busy_s": busy / 1e6,
            "kernels": dict(kernels), "families": dict(families),
            "gaps": idle_gaps(sorted((a, b) for _, a, b in device), host, lo, hi)}


def idle_gaps(intervals, host, lo, hi):
    """{label: idle seconds}: each stretch of the window with no device
    activity, named by the host activity that contains its midpoint (the
    one that began last, on any thread), or "host: no op" where none
    does."""
    gaps, end = [], lo
    for a, b in intervals:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if hi > end:
        gaps.append((end, hi))
    host = sorted(host)
    out = defaultdict(float)
    active, i = [], 0  # host activities begun before the midpoint, not yet ended
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (a + b) / 2
        while i < len(host) and host[i][0] <= mid:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1] >= mid]
        out[max(active)[2] if active else "host: no op"] += (b - a) / 1e6
    return dict(out)


def breakdown(trace):
    """The ten families and the ten host activities with the most device
    time and idle time in the traced window, in seconds."""
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return {"device_ops": top(trace["families"]), "idle_gaps": top(trace["gaps"])}
