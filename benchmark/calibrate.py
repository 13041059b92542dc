"""Readings that set a cell's limits for ``correct`` (not run by the
benchmark's own runs).

    python3 benchmark/calibrate.py --workload <cell> --seeds <n>... \\
        [--control-seeds <n>...] [--fault <name> --fault-seeds <n>...] [--seconds S]

For each of ``--seeds``: the program's sound run through the harness's own
set-up and a window of ``--seconds``, checked against the reference as a
run is. For each of ``--control-seeds``: the control, the reference in
fp8 (``reference.model``) put in the program's place on the same inputs.
For each of ``--fault-seeds``: the program with a fault of ``faults.py``
planted. One JSON line a reading: the compared numbers and, for training,
the five worst leaves of each norm comparison.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _free():
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def serve_reading(cell, seed, seconds, device, model, precision="fp32"):
    from benchmark import check, program, scenes
    t = cell["traffic"]
    if precision == "fp32":  # the program
        session = program.Serve(cell, seed, device, model=model)
        win = session.window(seconds)
        kept, pool = win["kept"], session.pool
        del session
    else:  # the reference at lower precision in the program's place
        pool = scenes.make_pool(seed, t["pool"], t["batch"], t["height"], t["width"],
                                t["nviews"], t["numdepth"], device, with_gt=False)
        low = check.reference_serve(cell["config"], pool, range(len(pool)), device, precision)
        kept = [(s, s, {"depth": a["stage3"]["depth"],
                        "photometric_confidence": a["stage3"]["photometric_confidence"],
                        **{f"stage{i}": a[f"stage{i}"] for i in (1, 2)}})
                for s, a in low.items()]
    _free()
    answers = check.reference_serve(cell["config"], pool, [s for _, s, _ in kept], device)
    return {"numbers": check.serve_numbers(kept, answers, pool)}


def train_reading(cell, seed, device, precision="fp32"):
    from benchmark import check, program, scenes
    t, cfg = cell["traffic"], cell["config"]
    if precision == "fp32":
        session = program.SESSIONS[t["kind"]](cell, seed, device)
        try:
            first, pool = session.first, session.pool
        finally:
            session.close()
        del session
    else:
        pool = scenes.make_pool(seed, t["first_steps"], t["batch"], t["height"], t["width"],
                                t["nviews"], t["numdepth"], device, with_gt=True)
        first = check.reference_train(cfg, pool, t["iters_per_epoch"], device, precision)
    _free()
    ref = check.reference_train(cfg, pool[:t["first_steps"]], t["iters_per_epoch"], device)
    worst = {k: [[round(g, 6), leaf, norm_of(first, k, leaf), norm_of(ref, k, leaf)]
                 for g, leaf in v[:5]] for k, v in check.leaf_gaps(first, ref).items()}
    return {"numbers": check.train_numbers(first, ref, pool[0]),
            "readings": check.train_readings(first, ref, pool[0]), "losses": first["losses"],
            "ref_losses": ref["losses"], "worst": worst}


def norm_of(side, number, leaf):
    """The leaf's norm that ``number`` compares, on one side."""
    return side["grad_norms" if number == "grad" else "change_norms"][leaf]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault", default=None)
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--dtype", default=None,
                   help="the program's compute dtype in place of the configuration's, "
                        "for a second witness (float32)")
    args = p.parse_args(argv)

    import torch

    from benchmark import cells, faults, program
    cell = cells.load(args.workload)
    if args.dtype:
        cell["config"]["compute_dtype"] = args.dtype
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    serve = program.SESSIONS[cell["traffic"]["kind"]].GROUP == "serve"
    model = program.build_model(cell["config"], "serve", device) if serve else None

    def reading(kind, seed, precision="fp32"):
        r = (serve_reading(cell, seed, args.seconds, device, model, precision) if serve
             else train_reading(cell, seed, device, precision))
        print(json.dumps({"workload": args.workload, "kind": kind, "seed": seed, **r}),
              flush=True)

    for seed in args.seeds:
        reading("program" if not args.dtype else f"program_{args.dtype}", seed)
    for seed in args.control_seeds:
        reading("control_fp8", seed, "fp8")
    for seed in args.fault_seeds:
        with faults.FAULTS[args.fault]():
            reading(f"fault_{args.fault}", seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
