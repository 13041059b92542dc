"""The untraced split of a serving cell's request, from DepthRunner's
counters, on one card.

    python3 scripts/serving_split_torch.py --workload fmt_serve [--seconds 20]
        [--seed 7] [--trees _checkouts/parent . . _checkouts/parent]

Each tree (a checkout of the repository; default the one this script is in)
runs in a process of its own, in the order given, with that tree's benchmark
session for the cell (``benchmark/program.py``: its model, weights, pool and
warm-up), then a closed loop of requests for ``--seconds`` with no profiler.
Prints one JSON line a tree, ms a request: ``request_ms`` (the window over
its requests), ``upload_ms`` (``time_upload``: the pinned fill and the
copy's enqueue), ``enqueue_ms`` (``time_dispatch`` less the upload: the
host's forward), ``fetch_ms`` (``time_fetch``: the wait for the device and
the answers' copies), and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = """
import json, sys, time, torch
from benchmark import cells, program
from benchmark.run import card
cell = cells.load(sys.argv[1])
session = program.Serve(cell, int(sys.argv[2]), torch.device("cuda", 0))
r = session.runner
base = (r.time_upload, r.time_dispatch, r.time_fetch)
win = session.window(float(sys.argv[3]))
n = win["units"]
upload, dispatch, fetch = (1e3 * (now - then) / n for now, then in
                           zip((r.time_upload, r.time_dispatch, r.time_fetch), base))
print(json.dumps({"workload": sys.argv[1], "requests": n,
                  "request_ms": 1e3 * win["window_s"] / n, "upload_ms": upload,
                  "enqueue_ms": dispatch - upload, "fetch_ms": fetch, "card": card()}))
"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--trees", nargs="+", default=[REPO])
    args = ap.parse_args()
    for tree in args.trees:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", CHILD, args.workload, str(args.seed),
                               str(args.seconds)], cwd=tree, capture_output=True, text=True,
                              env=dict(os.environ, PYTHONPATH=os.path.abspath(tree)))
        if proc.returncode:
            sys.stderr.write(proc.stderr[-4000:])
            return proc.returncode
        row = json.loads(proc.stdout.splitlines()[-1])
        print(json.dumps({"tree": tree, **row, "process_s": time.perf_counter() - t0}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
