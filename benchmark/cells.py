"""Finding a cell's parts by name.

``BENCHMARK.json`` (at the root of the checkout) names each cell's
configuration and traffic; their files are ``configs/<config>.json`` and
``traffic/<traffic>.json`` beside this file, the cell's limits for
``correct`` are ``limits/<cell>.json``, and each metric is read by
``metrics/<metric>.py``, whose ``read(record)`` returns a number or None.
A cell reports the end-to-end metrics that list it (or list no cells)
and the per-layer metrics that list it. Adding a cell, a configuration or
a metric adds files and entries; no file here names one.

A configuration names its reference with ``"reference"``: a module under
``reference/`` (``reference.for_config``; without the key, the default).
It is refused where it holds a key that nothing reads, or a model,
optimizer or loss setting that its reference does not implement (the
module's ``settings``); a traffic mix where its keys are not the ones its
kind's session reads (``program.SESSIONS``).
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
from pathlib import Path

from . import program, reference

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CONFIG_KEYS = {"name", "source", "source_settings", "reference", "model", "compute_dtype",
               "weights", "weights_sha256", "serve", "train", "dataset", "reduced", "assumed"}


def _json(path):
    with open(path) as f:
        return json.load(f)


def sha256(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def load(workload, bench=None, here=HERE):
    """The cell: {"name", "chips", "config", "traffic", "limits",
    "end_to_end", "per_layer" (metric entries of BENCHMARK.json), "dir"
    (where its files are: ``here``)}. The configuration's weights are read
    from the checkout root and must be the file it names by hash."""
    bench = bench if bench is not None else _json(ROOT / "BENCHMARK.json")
    here = Path(here)
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cfg = _json(here / "configs" / f"{entry['config']}.json")
    traffic = _json(here / "traffic" / f"{entry['traffic']}.json")
    if set(cfg) - CONFIG_KEYS:
        raise SystemExit(f"configs/{entry['config']}.json: keys nothing reads: "
                         f"{sorted(set(cfg) - CONFIG_KEYS)}")
    session = program.SESSIONS[traffic["kind"]]
    if set(traffic) != session.KEYS:
        raise SystemExit(f"traffic/{entry['traffic']}.json holds {sorted(traffic)}, a "
                         f"{traffic['kind']} session reads {sorted(session.KEYS)}")
    try:
        reference.for_config(cfg).settings(cfg, session.GROUP)
    except ValueError as e:
        raise SystemExit(f"configs/{entry['config']}.json: {e}") from e
    cfg["weights"] = str(ROOT / cfg["weights"])
    if sha256(cfg["weights"]) != cfg["weights_sha256"]:
        raise SystemExit(f"{cfg['weights']} is not the file configs/{entry['config']}.json "
                         "names (sha256 differs)")
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    per_layer = [m for m in bench["per_layer"] if workload in m["workloads"]]
    return {"name": workload, "chips": entry["chips"], "config": cfg, "traffic": traffic,
            "limits": _json(here / "limits" / f"{workload}.json"),
            "end_to_end": e2e, "per_layer": per_layer, "dir": here}


def reader(metric, here=HERE):
    """``read`` of metrics/<metric>.py under ``here``."""
    path = Path(here) / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"_bench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metrics(entries, record, here=HERE):
    """{name: {"value", "unit"}} of the entries whose reader (under
    ``here``) finds something in the record."""
    out = {}
    for m in entries:
        value = reader(m["name"], here)(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
