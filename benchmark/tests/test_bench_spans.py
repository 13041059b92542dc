"""The per-span reduction (``benchmark/spans.py``) on canned lists, times
in ns: activities credited to the span open at their launch on any
thread, sums that roll up to parent spans, idle gaps to the innermost
span, launches not found and activities before their launch counted;
the readers of the spans' idle gaps on records with and without the
port's spans; and ``reduce`` on a CPU profile."""
from __future__ import annotations

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import cells, spans, trace

from damvsnet_tpu_torch.train.profiler import span

MAIN = 1  # the thread that opens the spans


def test_backward_thread_launch_is_credited_to_loop_backward():
    s = [(0, 90, "loop.forward", MAIN), (100, 200, "loop.backward", MAIN)]
    launches = {1: 50, 2: 150}  # 2: launched by autograd's thread, no span of its own
    device = [(60, 80, 1), (160, 190, 2)]
    out = spans.summarize(s, launches, device, 0, 200)["spans"]
    assert out["loop.forward"]["device_s"] == pytest.approx(20e-9)
    assert out["loop.backward"]["device_s"] == pytest.approx(30e-9)
    assert out["loop.backward"]["launches"] == 1 and out["loop.backward"]["calls"] == 1


def test_sums_roll_up_to_parent_spans():
    s = [(0, 100, "runner.forward", MAIN), (10, 40, "cascade.stage1.cost_reg", MAIN),
         (50, 70, "cascade.stage1.stats", MAIN), (110, 120, "runner.fetch", MAIN)]
    launches = {1: 20, 2: 30, 3: 60, 4: 80}
    device = [(20, 40, 1), (40, 50, 2), (60, 65, 3), (80, 110, 4)]
    out = spans.summarize(s, launches, device, 0, 120)["spans"]
    assert out["cascade.stage1.cost_reg"]["device_s"] == pytest.approx(30e-9)
    assert out["cascade.stage1.stats"]["device_s"] == pytest.approx(5e-9)
    assert out["runner.forward"]["device_s"] == pytest.approx(65e-9)
    assert out["runner.forward"]["launches"] == 4 and out["runner.fetch"]["launches"] == 0
    assert list(out) == ["runner.forward", "cascade.stage1.cost_reg",
                         "cascade.stage1.stats", "runner.fetch"]


def test_gaps_go_to_the_innermost_span():
    s = [(0, 100, "runner.forward", MAIN), (20, 60, "cascade.stage2.samples", MAIN)]
    launches = {1: 0, 2: 10, 3: 10}
    device = [(0, 30, 1), (50, 80, 2), (90, 100, 3)]  # gaps 30-50 (mid 40), 80-90, 100-120
    r = spans.summarize(s, launches, device, 0, 120)
    assert r["spans"]["cascade.stage2.samples"]["idle_s"] == pytest.approx(20e-9)
    assert r["spans"]["runner.forward"]["idle_s"] == pytest.approx(30e-9)
    assert r["span_check"]["outside_idle_s"] == pytest.approx(20e-9)
    assert r["span_check"]["idle_s"] == pytest.approx(50e-9)


def test_unresolved_and_early_activities_are_counted():
    s = [(0, 100, "runner.forward", MAIN)]
    launches = {1: 10, 2: 50}
    device = [(20, 30, 1), (40, 45, 2), (60, 70, 9), (300, 400, 1)]  # 2 before its launch
    c = spans.summarize(s, launches, device, 0, 100)["span_check"]
    assert (c["activities"], c["unresolved"], c["early"]) == (3, 1, 1)
    assert c["early_max_s"] == pytest.approx(10e-9)
    assert c["outside_device_s"] == pytest.approx(10e-9)
    assert c["device_s"] == pytest.approx(25e-9)


def test_idle_readers_need_the_port_spans():
    device = [("k", 0, 10), ("k", 40, 50)]  # us; one gap, 10-40
    parent = trace.summarize(device, [(0, 50, "bench.window/bench.request"),
                                      (5, 45, "bench.request/aten::conv2d")], 0, 50, 1)
    child = trace.summarize(device, [(0, 50, "bench.window/bench.request"),
                                     (5, 45, "bench.request/runner.forward")], 0, 50, 1)
    serve = cells.reader("runner.forward_idle_ms.serve")
    assert serve({"kind": "serve", "trace": parent}) is None
    assert serve({"kind": "serve", "trace": child}) == pytest.approx(0.03)
    assert serve({"kind": "serve"}) is None
    train = cells.reader("loop.loss_idle_ms.train")
    assert train({"kind": "serve", "trace": child}) is None
    step = trace.summarize(device, [(0, 50, "bench.window/bench.step"),
                                    (5, 45, "bench.step/loop.loss")], 0, 50, 2)
    assert train({"kind": "train", "trace": step}) == pytest.approx(0.015)
    assert train({"kind": "train", "trace": dict(step, gaps={})}) is None


def test_reduce_reads_the_port_spans_from_a_profile():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(trace.WINDOW_SPAN):
            for _ in range(2):
                with span("runner.forward"):
                    with span("cascade.features"):
                        torch.ones(8) + 1
            with torch.profiler.record_function("bench.request"):
                pass
    r = spans.reduce(prof)
    assert {k: v["calls"] for k, v in r["spans"].items()} == {
        "runner.forward": 2, "cascade.features": 2}
    assert r["span_check"]["activities"] == 0
