"""The benchmark's arithmetic on canned inputs: the idle share over
overlapping device activities, idle gaps named by host activity, the
family classifier, the copied kernel bounds, the FLOP count of a 3-D
convolution, the readers' shares; and a cell and a metric added as new
files only, found by name and run."""
from __future__ import annotations

import hashlib
import importlib.util
import json
import shutil
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import cells, ranks, trace, yardstick
from benchmark.reference.model import Cascade
from benchmark.run import run

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


def test_union_counts_overlapping_kernels_once():
    assert yardstick.union_length([(0, 10), (5, 15), (12, 14), (20, 25)]) == 20
    device = [("k_a", 0, 10), ("k_b", 5, 15), ("k_c", 20, 25)]  # us; a and b overlap
    host = [(15, 20, "bench.request/aten::to"), (25, 40, "bench.read")]
    t = trace.summarize(device, host, 0, 40, units=2)
    assert t["busy_s"] == pytest.approx(20e-6)
    assert t["window_s"] == pytest.approx(40e-6)
    assert cells.reader("device.idle_share.serve")({"kind": "serve", "trace": t}) == \
        pytest.approx(50.0)
    assert t["gaps"] == pytest.approx({"bench.request/aten::to": 5e-6, "bench.read": 15e-6})
    assert sum(t["kernels"][k][0] for k in t["kernels"]) == pytest.approx(25e-6)


def test_gap_named_by_innermost_host_activity():
    host = [(0, 100, "bench.window/bench.request"), (40, 60, "bench.request/aten::copy_")]
    gaps = trace.idle_gaps([(0, 30), (70, 100)], host, 0, 100)
    assert gaps == pytest.approx({"bench.request/aten::copy_": 40e-6})
    assert trace.idle_gaps([(0, 10)], [], 0, 20) == pytest.approx({"host: no op": 10e-6})


@pytest.mark.parametrize("name, fam", [
    ("void fused_costvol_kernel<__nv_bfloat16, 32>(...)", "K1 fused cost volume"),
    ("void fused_costvol_bwd_kernel<float, 8>(...)", "K3 fused cost volume backward"),
    ("probstats_kernel", "K2 prob stats"),
    ("sweep_variance_kernel<16>", "K4 variance cost volume"),
    ("void cudnn::bn_fw_tr_1C11_kernel_NCHW<float>(...)", "batch norm"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16", "convolution"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "elementwise"),
    ("void at::native::_scatter_gather_elementwise_kernel<...>", "gather / scatter"),
    ("Memcpy HtoD (Pageable -> Device)", "copy / layout"),
    ("void at::native::(anonymous)::upsample_bilinear2d_out_frame", "resize"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
     "collective (NCCL)"),
    ("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)", "collective (NCCL)"),
    ("some_new_kernel", "other"),
])
def test_family(name, fam):
    assert yardstick.family(name) == fam


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("stage", [0, 1, 2])
@pytest.mark.parametrize("elem", [2, 4])
def test_bounds_equal_chip_smoke(stage, elem):
    cs = _chip_smoke()
    h, w, d, c = cs.HEIGHT >> (2 - stage), cs.WIDTH >> (2 - stage), cs.NDEPTHS[stage], \
        cs.STAGE_C[stage]
    pp = stage > 0
    assert yardstick.k1_bound_ms(1, d, h, w, c, 4, elem, pp) == cs.k1_bound_ms(
        1, d, h, w, c, 4, elem, pp)[0]
    assert yardstick.k2_bound_ms(1, d, h, w, pp, elem) == cs.k2_bound_ms(1, d, h, w, pp, elem)[0]
    assert yardstick.k4_variance_bound_ms(1, d, h, w, c, 4, elem, pp) == \
        cs.k4_variance_bound_ms(1, d, h, w, c, 4, elem, pp)[0]


def test_serving_bounds_sum_the_stages():
    cell = cells.load("dtu_serve")
    got = yardstick.serving_bounds_ms(cell["config"]["model"], cell["traffic"], "bfloat16")
    want = sum(yardstick.k1_bound_ms(1, d, 864 >> (2 - i), 1152 >> (2 - i), c, 4, 2, i > 0)
               for i, (d, c) in enumerate(zip((64, 32, 8), (32, 16, 8))))
    assert got["k1"] == pytest.approx(want) and "k4var" not in got


def test_conv3d_flops_hand_count():
    cout, cin, k, d, h, w = 16, 8, 3, 4, 16, 16
    net = Cascade({"c.weight": torch.empty(cout, cin, k, k, k, device="meta")}, {}, {})
    with FlopCounterMode(display=False) as counter:
        net.conv(torch.empty(1, cin, d, h, w, device="meta"), "c", 1, 1)
    assert counter.get_total_flops() == 2 * cout * cin * k ** 3 * d * h * w


def test_readers_shares():
    record = {"kind": "serve", "chips": 1, "units": 10, "window_s": 2.0, "samples_per_unit": 1,
              "flops_per_unit": 1e12, "bounds_ms": {"k1": 0.5},
              "trace": {"units": 2, "kernels": {"void fused_costvol_kernel<bf16>": [0.004, 6]},
                        "families": {}, "busy_s": 1.0, "window_s": 1.0, "gaps": {}}}
    assert cells.reader("kernels.k1_roofline.serve")(record) == pytest.approx(25.0)
    assert cells.reader("kernels.k4var_roofline.serve")(record) is None
    assert cells.reader("device.mfu.serve")(record) == pytest.approx(
        100 * 1e12 * 5 / yardstick.BF16_FLOPS_PER_S)
    assert cells.reader("device.mfu.train")(record) is None
    assert cells.reader("depth_maps_per_s")(record) == pytest.approx(5.0)
    four = {"kind": "train", "chips": 4, "units": 10, "window_s": 2.0, "samples_per_unit": 4,
            "flops_per_unit": 1e12, "trace": None}
    assert cells.reader("device.mfu.train")(four) == pytest.approx(
        100 * 1e12 * 5 / (4 * yardstick.BF16_FLOPS_PER_S))
    assert cells.reader("train_samples_per_s")(four) == pytest.approx(20.0)


def test_nccl_reader_reads_the_rank_that_waits_least():
    nccl = yardstick.family("ncclDevKernel_AllReduce_Sum_f32_RING_LL")
    t = {"units": 2, "kernels": {}, "busy_s": 1.0, "window_s": 1.0, "gaps": {},
         "families": {nccl: 0.5, "convolution": 0.2}, "nccl_s": [0.5, 0.03, 0.2, 0.04]}
    assert nccl == ranks.NCCL
    read = cells.reader("dist.nccl_ms.train")
    assert read({"kind": "train", "trace": t}) == pytest.approx(15.0)
    assert read({"kind": "serve", "trace": t}) is None
    one_card = {k: v for k, v in t.items() if k != "nccl_s"}
    for none in (one_card, {**t, "nccl_s": [0.0, 0.0, 0.0, 0.0]}):
        assert read({"kind": "train", "trace": none}) is None


def _digest(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_and_metric_are_files_only(tmp_path, cpu):
    """A later change adds a traffic mix, a cell's limits and a metric as
    new files and entries; the harness finds them by name and reports the
    new metric, and no existing file changes."""
    before = _digest(BENCH)
    here = tmp_path / "bench"
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(BENCH / sub, here / sub)
    tiny = json.loads((BENCH / "traffic" / "dtu_eval.json").read_text())
    tiny.update(height=128, width=160, nviews=3, pool=2, check_sample=2)
    (here / "traffic" / "tiny_eval.json").write_text(json.dumps(tiny))
    (here / "limits" / "tiny_serve.json").write_text(
        (BENCH / "limits" / "dtu_serve.json").read_text())
    (here / "metrics" / "request_ms_p50.py").write_text(
        "import statistics\n\n\ndef read(record):\n"
        "    return 1e3 * statistics.median(record['latencies_s'])\n")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny_serve", "config": "damvsnet_dtu",
                               "traffic": "tiny_eval", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "request_ms_p50", "unit": "ms", "better": "lower",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["tiny_serve"]})
    cell = cells.load("tiny_serve", bench, here=here)
    assert cell["traffic"]["height"] == 128
    assert [m["name"] for m in cell["end_to_end"]] == ["setup_s", "request_ms_p50"]
    cell["config"]["compute_dtype"] = "float32"
    result, _ = run(cell, 7, 0.5, False, cpu, 0.0)
    assert result["correct"] and result["metrics"]["request_ms_p50"]["value"] > 0
    assert _digest(BENCH) == before


def test_cells_report_their_metrics(load_cell):
    serve, train = cells.load("dtu_serve"), cells.load("dtu_train")
    assert {m["name"] for m in serve["end_to_end"]} == {
        "depth_maps_per_s", "request_ms_p95", "setup_s"}
    assert {m["name"] for m in train["end_to_end"]} == {"train_samples_per_s", "setup_s"}
    assert "kernels.k1_roofline.serve" in {m["name"] for m in serve["per_layer"]}
    assert "kernels.k4var_roofline.serve" in {
        m["name"] for m in cells.load("variance_serve")["per_layer"]}
    assert all(m["name"].endswith(".train") for m in train["per_layer"])
    # the cell on four cards, whose entry waits for a bound, would read the
    # training cell's metrics less the batch-norm family (the synced
    # BatchNorm launches none of its kernels), with NCCL's; each has a reader
    ddp = load_cell("dtu_train_ddp4")
    assert ddp["chips"] == 4 and ddp["config"] == train["config"]
    assert {m["name"] for m in ddp["end_to_end"]} == {"train_samples_per_s", "setup_s"}
    assert {m["name"] for m in ddp["per_layer"]} == {
        m["name"] for m in train["per_layer"]} - {"nn.bn_ms.train"} | {"dist.nccl_ms.train"}
    for m in ddp["end_to_end"] + ddp["per_layer"]:
        assert callable(cells.reader(m["name"]))
