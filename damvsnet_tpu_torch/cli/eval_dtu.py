"""DTU evaluation CLI (replaces evaluations/dtu/*.m); a copy of
damvsnet_tpu/cli/eval_dtu.py, host numpy and scipy.

    python -m damvsnet_tpu_torch.cli.eval_dtu --ply_dir outputs/dtu \
        --data_path /data/DTU/SampleSet/MVS\\ Data \
        --scans 1 4 9 10 ...
"""
from __future__ import annotations

import argparse
import json

DTU_TEST_SCANS = [1, 4, 9, 10, 11, 12, 13, 15, 23, 24, 29, 32, 33, 34, 48,
                  49, 62, 75, 77, 110, 114, 118]


def main(argv=None):
    p = argparse.ArgumentParser("damvsnet-tpu-torch eval-dtu")
    p.add_argument("--ply_dir", required=True)
    p.add_argument("--data_path", required=True,
                   help="DTU SampleSet/MVS Data root (Points/stl + ObsMask)")
    p.add_argument("--scans", type=int, nargs="*", default=DTU_TEST_SCANS)
    p.add_argument("--method", default="mvsnet")
    p.add_argument("--light", default="l3")
    p.add_argument("--out_json", default=None)
    args = p.parse_args(argv)

    from ..eval.dtu_eval import evaluate_scans
    results, summary = evaluate_scans(args.ply_dir, args.data_path, args.scans,
                                      args.method, args.light)
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump({"per_scan": {str(k): v for k, v in results.items()},
                       "summary": summary}, f, indent=2)


if __name__ == "__main__":
    main()
