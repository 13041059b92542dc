"""The port's spans and counters on the CPU (``train/profiler.py`` ``span``):
with no profiler running a span enters nothing; under torch.profiler a
DepthRunner call and a train step open exactly their named spans, once
each, nested as documented (with FMT, ``cascade.fmt`` and its three parts); DepthRunner's ``time_upload`` is a part of its
``time_dispatch``. A tiny cascade: ndepths (8, 8, 8), synthetic scenes at
32x32, N=3."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from damvsnet_tpu_torch.data import DataLoader, SyntheticDataset
from damvsnet_tpu_torch.infer import DepthRunner
from damvsnet_tpu_torch.model import CascadeMVSNet
from damvsnet_tpu_torch.train.loop import make_train_step
from damvsnet_tpu_torch.train.profiler import span
from damvsnet_tpu_torch.train.schedule import make_optimizer
from damvsnet_tpu_torch.train.state import TrainState

torch.set_num_threads(1)

PORT = ("runner.", "cascade.", "loop.")


@pytest.fixture(autouse=True)
def no_onednn():
    """Torch's own CPU convolutions (tests/test_torch_train_loop.py)."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _batch(size):
    ds = SyntheticDataset(height=32, width=32, nviews=3, ndepths=16, length=size)
    return next(DataLoader(ds, batch_size=size, num_workers=0).iter_epoch(0))


def _request():
    batch = _batch(1)
    return {k: batch[k] for k in ("imgs", "proj_matrices", "depth_values")}


def _model(**kwargs):
    torch.manual_seed(0)
    return CascadeMVSNet(ndepths=(8, 8, 8), device="cpu", **kwargs)


def _port_spans(fn):
    """[(span, the port's span it opened inside or None)] of one call of
    ``fn`` under torch.profiler, in the order they opened."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    events = sorted((e for e in prof.events()
                     if e.is_user_annotation and e.name.startswith(PORT)),
                    key=lambda e: e.time_range.start)
    out = []
    for e in events:
        p = e.cpu_parent
        while p is not None and not p.name.startswith(PORT):
            p = p.cpu_parent
        out.append((e.name, None if p is None else p.name))
    return out


def _cascade(parent, geo_fusion, fmt=False):
    out = [("cascade.features", parent)]
    if fmt:
        out += [("cascade.fmt", parent)] + [(f"cascade.fmt.{part}", "cascade.fmt")
                                            for part in ("ref", "src", "pathway")]
    for k in (1, 2, 3):
        if k > 1 and geo_fusion:
            out.append((f"cascade.stage{k}.geo_fusion", parent))
        out += [(f"cascade.stage{k}.{part}", parent)
                for part in ("samples", "cost_volume", "cost_reg", "stats")]
    return out


def test_span_without_profiler_enters_nothing(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert span("runner.forward") is span("loop.loss")
    DepthRunner(_model(), "cpu")(_request())


@pytest.mark.parametrize("agg_mode, geo_fusion", [("adaptive", True), ("variance", False)])
def test_runner_opens_its_spans_and_the_cascade_stages(agg_mode, geo_fusion):
    runner = DepthRunner(_model(agg_mode=agg_mode, use_geo_fusion=geo_fusion), "cpu")
    request = _request()
    assert _port_spans(lambda: runner(request)) == (
        [("runner.upload", None), ("runner.forward", None)]
        + _cascade("runner.forward", geo_fusion) + [("runner.fetch", None)])


def test_train_step_opens_its_spans():
    model = _model()
    opt, sched = make_optimizer(model.parameters(), 1e-3, "10,12,14:2", iters_per_epoch=4)
    state, batch = TrainState(model, opt, sched), _batch(2)
    step = make_train_step(device="cpu")
    assert _port_spans(lambda: step(state, batch)) == (
        [("loop.forward", None)] + _cascade("loop.forward", True)
        + [(f"loop.{part}", None) for part in ("loss", "backward", "optimizer", "metrics")])


def test_runner_upload_is_a_part_of_dispatch():
    runner = DepthRunner(_model(), "cpu")
    request = _request()
    for _ in range(2):
        runner(request)
    assert 0 < runner.time_upload <= runner.time_dispatch
    assert runner.time_fetch > 0


def test_fmt_spans_without_profiler_enter_nothing(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    DepthRunner(_model(use_fmt=True), "cpu")(_request())


def test_runner_opens_the_fmt_spans_in_order():
    """An FMT forward opens ``cascade.fmt`` after ``cascade.features`` and,
    inside it, the reference's layers, the sources' and the pathway."""
    runner = DepthRunner(_model(use_fmt=True), "cpu")
    request = _request()
    assert _port_spans(lambda: runner(request)) == (
        [("runner.upload", None), ("runner.forward", None)]
        + _cascade("runner.forward", True, fmt=True) + [("runner.fetch", None)])
