"""Can ``fmt_serve``'s check tell FMT left out? The plain FMT reference
(benchmark/reference/fmt.py) with its eight encoder layers replaced by
identity (the sine encoding and the pathway kept) stands in the program's
place, as benchmark/calibrate.py's control does, and is compared with the
whole reference on the same scenes: the compared numbers beside the cell's
limits, one JSON line a seed.

    python3 scripts/fmt_left_out_torch.py --seeds <n>... [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WORKLOAD = "fmt_serve"  # the one cell whose configuration runs FMT


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    from benchmark import cells, check, scenes
    from benchmark.reference import fmt

    class LayersLeftOut(fmt.FmtCascade):
        def encoder_layer(self, x, source, i):
            return x

    cell = cells.load(WORKLOAD)
    cfg, t = cell["config"], cell["traffic"]
    device = torch.device(args.device)
    rcfg = fmt.settings(cfg, "serve")["model"]
    params, buffers = fmt.load_weights(cfg["weights"], rcfg, device)
    for seed in args.seeds:
        pool = scenes.make_pool(seed, t["pool"], t["batch"], t["height"], t["width"],
                                t["nviews"], t["numdepth"], device, with_gt=False)
        kept = []
        for s in range(len(pool)):
            a = {k: {n: v.cpu().numpy() for n, v in out.items()} for k, out in
                 fmt.serve(params, buffers, rcfg, pool[s], cascade=LayersLeftOut).items()}
            kept.append((s, s, {"depth": a["stage3"]["depth"],
                                "photometric_confidence": a["stage3"]["photometric_confidence"],
                                "stage1": a["stage1"], "stage2": a["stage2"]}))
        answers = check.reference_serve(cfg, pool, range(len(pool)), device)
        numbers = check.serve_numbers(kept, answers, pool)
        correct, checked = check.judge(numbers, cell["limits"])
        print(json.dumps({"workload": WORKLOAD, "kind": "fmt_left_out", "seed": seed,
                          "numbers": numbers, "correct": correct, "checked": checked}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
