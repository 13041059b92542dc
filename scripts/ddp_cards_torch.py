"""Data-parallel fused training across the cards of one machine, one rank a
card over NCCL: chip_smoke.py's phase 17 with every card.

    python3 scripts/ddp_cards_torch.py          (needs 2 or more cards)

Builds the kernels, then runs phase 17's step (512x640, global B=4, N=5,
bf16, the trained weights, Adam, CPC) on as many ranks as there are cards
(4 must divide by their number): each rank its rows of every global batch,
1 warm and 3 timed steps with the launch counters, one more step profiled
for its collectives, then one fp32 step (TF32 off) held against the same
step in one process at B=4 on card 0, at phase 17's limits. Prints the
phase's line and each card's name and power limit.
"""
from __future__ import annotations

import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    sys.path.insert(0, REPO)
    os.chdir(REPO)
    import torch

    import chip_smoke as smoke
    from damvsnet_tpu_torch.ops.kernels import build

    if not torch.cuda.is_available():
        print("ddp_cards_torch: no CUDA device", file=sys.stderr)
        return 2
    cards = torch.cuda.device_count()
    if cards < 2 or smoke.TRAIN_B % cards:
        print(f"ddp_cards_torch: {cards} cards; needs 2 or more that divide "
              f"{smoke.TRAIN_B}", file=sys.stderr)
        return 2
    build.build()
    smi = smoke.nvidia_smi()
    print(f"cards: {smi}", flush=True)
    with tempfile.TemporaryDirectory() as workdir:
        smoke.phase_ddp_train(torch.device("cuda:0"), smi, workdir, world=cards,
                              backend="nccl")
    return 0


if __name__ == "__main__":
    sys.exit(main())
