"""The port's training tooling against the JAX package's on the CPU: the
event writer (``train/logging.py``), the visualizations
(``utils/visualize.py``), the torch.profiler trace
(``train/profiler.py``), the Trainer's summaries and the training CLI's
``--profile_dir``."""
import ast
import functools
import glob
import json
import os
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from damvsnet_tpu.train import logging as jlogging
from damvsnet_tpu.utils import visualize as jviz
from damvsnet_tpu_torch import data as port_data
from damvsnet_tpu_torch.cli import train as cli_train
from damvsnet_tpu_torch.core.pfm import write_pfm
from damvsnet_tpu_torch.data import DataLoader, SyntheticDataset
from damvsnet_tpu_torch.model import CascadeMVSNet
from damvsnet_tpu_torch.train import logging as plogging
from damvsnet_tpu_torch.train.loop import Trainer, make_train_step
from damvsnet_tpu_torch.train.profiler import trace_path, trace_steps
from damvsnet_tpu_torch.train.schedule import make_optimizer
from damvsnet_tpu_torch.train.state import TrainState
from damvsnet_tpu_torch.utils import visualize as pviz

torch.set_num_threads(1)
pytest.importorskip("cv2")

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def no_onednn():
    """Torch's own CPU convolutions (tests/test_torch_train_loop.py)."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def read_records(path):
    """The TFRecord framing: [u64 length][masked crc32c of it][data][masked
    crc32c of the data]; every CRC checked. Returns the data of each."""
    blob = Path(path).read_bytes()
    out, i = [], 0
    while i < len(blob):
        header = blob[i:i + 8]
        (n,) = struct.unpack("<Q", header)
        (crc_h,) = struct.unpack("<I", blob[i + 8:i + 12])
        assert crc_h == jlogging._masked_crc32c(header)
        data = blob[i + 12:i + 12 + n]
        (crc_d,) = struct.unpack("<I", blob[i + 12 + n:i + 16 + n])
        assert crc_d == jlogging._masked_crc32c(data)
        out.append(data)
        i += 16 + n
    return out


def without_wall_time(event):
    """An Event record with its wall_time (field 1, a double, first) zeroed."""
    assert event[0] == 0x09
    return event[:1] + bytes(8) + event[9:]


def event_tags(event):
    """The Summary.Value tags of an event (field 5 -> field 1 -> field 1)."""
    i = 9
    assert event[i] == 0x10
    i += 1
    while event[i] & 0x80:
        i += 1
    i += 1
    assert event[i] == 0x2A
    tags = []
    summary = event[i + 1:]
    _, j = _varint(summary, 0)
    while j < len(summary):
        assert summary[j] == 0x0A
        n, j = _varint(summary, j + 1)
        value = summary[j:j + n]
        tn, k = _varint(value, 1)
        tags.append(value[k:k + tn].decode())
        j += n
    return tags


def _varint(b, i):
    v = shift = 0
    while True:
        v |= (b[i] & 0x7F) << shift
        i += 1
        if not b[i - 1] & 0x80:
            return v, i
        shift += 7


def _write(module, logdir, kind):
    rng = np.random.default_rng(0)
    w = module.SummaryWriter(str(logdir))
    if kind == "scalars":
        w.add_scalars("train", {"loss": 0.5, "abs_depth_error": 3.25}, 7)
        w.add_scalar("lr", 1e-3, 8)
    elif kind == "gray":
        w.add_image("train/depth", rng.random((12, 16)) * 500.0, 3)
    elif kind == "rgb":
        w.add_image("train/ref_img", (rng.random((12, 16, 3)) * 255).astype(np.uint8), 3)
    else:  # batched, as the JAX Trainer passes the step's images
        w.add_images("train", {"depth_est": rng.random((2, 12, 16)).astype(np.float32),
                               "ref_img": rng.random((12, 16, 3)).astype(np.float32),
                               "mask": np.ones((12, 16), np.float32)}, 5)
    w.close()
    [path] = glob.glob(os.path.join(str(logdir), "events.out.tfevents.*"))
    return read_records(path), (Path(logdir) / "metrics.jsonl").read_text()


@pytest.mark.parametrize("kind", ["scalars", "gray", "rgb", "batched"])
def test_event_records_equal_jax(tmp_path, kind):
    ours, our_jsonl = _write(plogging, tmp_path / "port", kind)
    theirs, their_jsonl = _write(jlogging, tmp_path / "jax", kind)
    assert len(ours) == len(theirs) >= 2
    assert [without_wall_time(e) for e in ours] == [without_wall_time(e) for e in theirs]
    strip = lambda text: [{k: v for k, v in json.loads(line).items() if k != "time"}
                          for line in text.splitlines()]
    assert strip(our_jsonl) == strip(their_jsonl)


@pytest.mark.parametrize("name", ["jet", "viridis", "coolwarm", "gray"])
def test_colormaps_equal_jax(name):
    x = np.linspace(-0.2, 1.2, 301)
    np.testing.assert_array_equal(pviz._colormap(x, name), jviz._colormap(x, name))


def _depth(rng):
    d = 400.0 + 400.0 * rng.random((24, 32))
    d[0, :5] = 0.0
    d[3, 3] = np.nan
    return d


@pytest.mark.parametrize("case", [
    ("depth_to_color", lambda m, rng: m.depth_to_color(_depth(rng))),
    ("depth_to_color_range_cmap", lambda m, rng: m.depth_to_color(
        _depth(rng), dmin=450.0, dmax=700.0, cmap="viridis")),
    ("depth_to_color_invalid", lambda m, rng: m.depth_to_color(
        _depth(rng), invalid_mask=rng.random((24, 32)) < 0.1, cmap="coolwarm")),
    ("confidence_to_color", lambda m, rng: m.confidence_to_color(rng.random((24, 32)))),
    ("confidence_to_color_threshold", lambda m, rng: m.confidence_to_color(
        rng.random((24, 32)) * 1.2 - 0.1, threshold=0.5)),
    ("error_to_color", lambda m, rng: m.error_to_color(_depth(rng), _depth(rng) + 3.0)),
    ("error_to_color_mask", lambda m, rng: m.error_to_color(
        _depth(rng), _depth(rng) + rng.standard_normal((24, 32)) * 4,
        mask=rng.random((24, 32)), max_error=4.0)),
], ids=lambda c: c[0])
def test_visualizations_equal_jax(case):
    _, fn = case
    ours, theirs = fn(pviz, np.random.default_rng(1)), fn(jviz, np.random.default_rng(1))
    assert ours.dtype == theirs.dtype == np.uint8
    np.testing.assert_array_equal(ours, theirs)


def test_exported_files_equal_jax(tmp_path):
    """save_depth_png, convert_depth_png and visualize_results_dir write the
    same files as JAX's."""
    import cv2

    for name, m in (("port", pviz), ("jax", jviz)):
        rng = np.random.default_rng(2)
        out = tmp_path / name
        scene = out / "scan1"
        for sub in ("depth_est", "confidence"):
            (scene / sub).mkdir(parents=True)
        for v in range(2):
            r = np.random.default_rng(v)
            write_pfm(str(scene / "depth_est" / f"{v:08d}.pfm"), _depth(r).astype(np.float32))
            write_pfm(str(scene / "confidence" / f"{v:08d}.pfm"),
                      r.random((24, 32)).astype(np.float32))
        m.save_depth_png(str(out / "depth.png"), _depth(np.random.default_rng(3)))
        cv2.imwrite(str(out / "raw16.png"), (rng.random((24, 32)) * 60000).astype(np.uint16))
        m.convert_depth_png(str(out / "raw16.png"), str(out / "converted"), depth_scale=0.25)
        assert m.visualize_results_dir(str(out), log_fn=lambda *_: None) == 4
    files = sorted(str(p.relative_to(tmp_path / "port")) for p in (tmp_path / "port").rglob("*.png"))
    assert len(files) == 3 + 6 and files == sorted(
        str(p.relative_to(tmp_path / "jax")) for p in (tmp_path / "jax").rglob("*.png"))
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f


def test_trace_steps_writes_a_trace(tmp_path):
    with trace_steps(str(tmp_path)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads(Path(trace_path(str(tmp_path))).read_text())
    assert trace_path(str(tmp_path)).endswith("trace_rank0.json")
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])


def _jax_image_keys():
    """The keys of the JAX step's ``metrics["_images"]`` dict literal
    (damvsnet_tpu/train/loop.py:92-99), read from its source."""
    tree = ast.parse((REPO / "damvsnet_tpu" / "train" / "loop.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Subscript)
                and getattr(node.targets[0].slice, "value", None) == "_images"):
            return [k.value for k in node.value.keys]
    raise AssertionError("no _images in the JAX step")


def test_trainer_writes_scalars_and_images(tmp_path):
    """At each summary step the Trainer writes the ``train`` scalars and the
    step's images (JAX's keys: the first sample's maps [H, W], the reference
    image [H, W, 3]); ``train_epoch`` and ``eval`` after their epochs."""
    ds = SyntheticDataset(height=32, width=32, nviews=3, ndepths=16, length=4)
    loader = DataLoader(ds, batch_size=2, num_workers=0)
    torch.manual_seed(0)
    model = CascadeMVSNet(ndepths=(8, 8, 8), device="cpu", fused_train=True)
    opt, sched = make_optimizer(model.parameters(), 1e-3, "10,12,14:2", iters_per_epoch=2)
    state = TrainState(model, opt, sched)
    metrics = make_train_step(device="cpu")(state, next(loader.iter_epoch(0)))
    images = metrics["_images"]
    assert list(images) == _jax_image_keys()
    for k, v in images.items():
        assert tuple(v.shape) == ((32, 32, 3) if k == "ref_img" else (32, 32)), k
        assert bool(torch.isfinite(v).all()), k

    trainer = Trainer(state, str(tmp_path), summary_freq=2, log_fn=lambda *_: None, device="cpu")
    trainer.train_epoch(loader.iter_epoch(0))
    trainer.eval_epoch(loader.iter_epoch(0))
    trainer.close()
    [path] = glob.glob(str(tmp_path / "events.out.tfevents.*"))
    tags = [t for e in read_records(path) for t in event_tags(e)]
    assert tags[0] == "_start"
    assert [t for t in tags if t.startswith("train/")] == (
        [f"train/{k}" for k in ("loss", "depth_loss", "cpc_loss", "abs_depth_error",
                                "thres2mm_error", "thres4mm_error", "thres8mm_error")]
        + [f"train/{k}" for k in _jax_image_keys()])
    assert sum(t.startswith("train_epoch/") for t in tags) == 7
    assert "eval/abserr_20.0mm_100000.0mm" in tags
    lines = [json.loads(x) for x in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [x["prefix"] for x in lines] == ["train", "train_epoch", "eval"]
    assert lines[0]["step"] == 3


def test_cli_profile_dir_writes_its_trace(monkeypatch, tmp_path):
    """``--profile_dir``: 1 warm and 5 traced steps on the epoch's first
    batch (they train, as the JAX CLI's do), the trace written, then the
    epoch; an event file in the log directory."""
    monkeypatch.setitem(port_data._REGISTRY, "synthetic",
                        functools.partial(SyntheticDataset, height=32, width=32, length=4))
    prof = tmp_path / "prof"
    trainer = cli_train.main(["--dataset", "synthetic", "--batch_size", "2", "--nviews", "3",
                              "--numdepth", "16", "--ndepths", "8,8,8", "--num_workers", "0",
                              "--device", "cpu", "--summary_freq", "1", "--epochs", "1",
                              "--fused_train", "--logdir", str(tmp_path / "run"),
                              "--profile_dir", str(prof)])
    assert trainer.state.step == 6 + 2
    trace = json.loads((prof / "trace_rank0.json").read_text())
    names = [e.get("name", "") for e in trace["traceEvents"]]
    assert any("convolution" in n for n in names)
    assert glob.glob(str(tmp_path / "run" / "events.out.tfevents.*"))
