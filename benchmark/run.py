"""One run of one benchmark cell of damvsnet_tpu_torch on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (an entry of ``BENCHMARK.json``)
names its configuration and traffic (``benchmark/configs``,
``benchmark/traffic``). The run sets up the program as the configuration
runs it, with inputs made from ``--seed``, warms up every shape the window
uses, runs the cell's loop for ``--seconds``, and then, with ``--trace 1``,
profiles a few more units of the same work. Once the program's state is
freed, the plain reference (``benchmark/reference``) recomputes what the
window's answers or first steps should be, and ``correct`` says whether
every compared number is within its limit (``benchmark/limits``). The
last line of standard output is the result as JSON: the end-to-end
metrics, or with ``--trace 1`` the per-layer ones; the last lines of
standard error are the compared numbers beside their limits.

A cell on more than one card runs one process a card (``ranks.py``):
this process is rank 0 on the first card. A rank that fails, or ranks
that outlast ``ranks.LIMIT_S`` besides the window, end the run with exit
code 4 and the tail of each rank's standard error.

It exits non-zero, printing no result, without enough CUDA devices, or
if JAX or the JAX package is loaded in the process once the window has
closed. The port's kernels build into its own ``ops/kernels/_build/``
inside the checkout.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FORBIDDEN = ("jax", "jaxlib", "flax", "damvsnet_tpu")


def forbidden_modules(names=None):
    """Loaded modules (or ``names``) whose top-level name, whole, is JAX's
    or the JAX package's."""
    return sorted({n.split(".")[0] for n in (sys.modules if names is None else names)}
                  & set(FORBIDDEN))


def run(cell, seed, seconds, traced, device, t_start):
    """Set-up, window, optional trace, then the check. Returns (result
    dict without "device", the compared numbers)."""
    import torch

    from benchmark import cells, check, program, trace, yardstick

    cfg, traffic = cell["config"], cell["traffic"]
    session = program.SESSIONS[traffic["kind"]](cell, seed, device)
    kind = session.GROUP
    try:
        setup_s = time.perf_counter() - t_start
        win = session.window(seconds)
        record = {"kind": kind, "chips": cell["chips"], "setup_s": setup_s,
                  "samples_per_unit": session.samples_per_unit,
                  **{k: win[k] for k in ("units", "window_s", "dispatch_s")},
                  "latencies_s": win.get("latencies_s")}
        result = {"attempted": win["units"], "failed": win.get("failed", 0)}
        if traced:
            units = traffic["trace_units"]
            record["trace"] = session.trace(units)
            result["breakdown"] = trace.breakdown(record["trace"])
        result["memory_peak_bytes"] = session.memory_peak_bytes()
        pool = session.pool
        first = getattr(session, "first", None)
    finally:
        session.close()
    del session
    if traced:
        record["flops_per_unit"] = yardstick.counted_flops(cfg, traffic, kind)
        if kind == "serve":
            record["bounds_ms"] = yardstick.serving_bounds_ms(cfg["model"], traffic,
                                                              cfg["compute_dtype"])
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if kind == "serve":
        kept = win["kept"]
        answers = check.reference_serve(cfg, pool, [s for _, s, _ in kept], device)
        numbers = check.serve_numbers(kept, answers, pool)
    else:
        numbers = check.train_numbers(first, check.reference_train(
            cfg, pool[:traffic["first_steps"]], traffic["iters_per_epoch"], device), pool[0])
    result["correct"], checked = check.judge(numbers, cell["limits"])
    result["metrics"] = cells.read_metrics(
        cell["per_layer"] if traced else cell["end_to_end"], record, cell["dir"])
    if traced:
        result["busy_s"], result["window_s"] = (record["trace"]["busy_s"],
                                                record["trace"]["window_s"])
    return result, checked


def card():
    """nvidia-smi's name and power limit of the card, for the log."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark import cells
    cell = cells.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"this machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result, checked = run(cell, args.seed, args.seconds, bool(args.trace), device, T_START)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in the run's process: {', '.join(bad)}", file=sys.stderr)
        return 3
    out = {"correct": result["correct"], "attempted": result["attempted"],
           "failed": result["failed"], "metrics": result["metrics"],
           "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                      "count": cell["chips"],
                      "memory_peak_bytes": result["memory_peak_bytes"]}}
    if args.trace:
        out["device"].update(busy_s=result["busy_s"], window_s=result["window_s"])
        out["breakdown"] = result["breakdown"]
    out["checked"] = checked
    print(f"card: {card()}", file=sys.stderr)
    for name, c in checked.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
